"""Data-adaptive grid depth — the port's own copy of
``nbody_tpu/ops/bh_autold.py`` (numpy; the JAX package cannot be imported).

The robust hybrid's default depth (ld = auto_ld + 2, at most 8) is right
for a core-dense input and wrong for a shell-like one.  This module prices
each candidate terminal level before the run:

* a host-side dry traversal mirrors K6's classification (far iff
  theta^2 * d2 > (border / 2^l)^2, with d2 the squared distance from the
  cell's centre of mass to the group's box; near iff not far and (cnt <=
  leaf_cap or terminal)) over a stratified sample of Morton groups, giving
  the near and far sources a depth-d grid would stage, and the cells it
  would pop;
* unit costs convert the volumes to milliseconds; ``choose_ld`` returns
  the argmin.

The unit costs are the port's own, measured on the H100 by
``chip_smoke.py`` [28] from K6's stats lanes and times and the set-up time
over the dense-grid nodes (PERF.md, PR 5).  ``NS_PER_TABLE_NODE`` prices
the persistent layout's per-step table rebuild (``ops/bh_persistent.py``),
measured on the H100 by ``chip_smoke.py`` [31] (PERF.md, the persistent layout).

The pick is cached on disk (``choose_ld_cached``) in the port's own file,
so the two packages never share picks made with different costs.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

# Unit costs measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
# [28]) over ld 5-8 of a 1M Plummer sphere with escapers (robust box) and
# ld 4-7 of the 1M uniform cloud, on K6 launched heaviest group first.
# Per 128 classified cells: the "pops" stage cut's time less the "none"
# cut's, timed on the card, against the cells classified (K6 classifies
# the 8 children of each popped cell; the estimate below counts the
# occupied ones), by least squares: 2.8972 ns.  Per staged source: K6's
# time less that, against the staged sources: 0.6271 ns.  The set-up's
# time per dense-grid node, the slope over ld 5-8 (its ~3-6 ms are
# per-body work), is kept from the fit that set it: the set-up has not
# changed since, and later fits of the same slope scatter between 0 and
# 0.1227.
NS_PER_SOURCE = 0.6271
NS_PER_POP = 2.8972
NS_PER_BUILD_NODE = 0.1120
# The persistent layout's per-step table rebuild (bh_persistent._ft_from_state)
# per dense-grid node, used when `persistent` is asked for: its time on an
# NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py [31]) over ld 5-8 of the
# robust input's state (1M Plummer sphere with 8 escapers, K = 1,953),
# 0.9649 / 1.0094 / 1.5589 / 5.7281 ms, against the nodes, by least squares
# (the 1M uniform cloud's state gave 0.2517).  The JAX package's v5e value,
# 9.7, priced an ld-8 rebuild at 186 ms and made the persistent robust run
# pick ld 7, where K6 took 86.5 ms against 32.8 at ld 8.
NS_PER_TABLE_NODE = 0.2492

_CACHE_SCHEMA = 4  # bump when pricing constants / probe semantics change


def _np_spread3(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint32)
    v = (v | (v << np.uint32(16))) & np.uint32(0x030000FF)
    v = (v | (v << np.uint32(8))) & np.uint32(0x0300F00F)
    v = (v | (v << np.uint32(4))) & np.uint32(0x030C30C3)
    v = (v | (v << np.uint32(2))) & np.uint32(0x09249249)
    return v


def np_morton_encode(pos: np.ndarray, border: float, depth: int) -> np.ndarray:
    """NumPy mirror of ``ops.morton.morton_encode`` (same clip and
    centring)."""
    n_cells = np.float32(2**depth)
    scaled = (pos.astype(np.float32) / np.float32(border) + 0.5) * n_cells
    cell = np.clip(scaled.astype(np.int32), 0, 2**depth - 1).astype(np.uint32)
    key = (
        _np_spread3(cell[:, 0])
        | (_np_spread3(cell[:, 1]) << np.uint32(1))
        | (_np_spread3(cell[:, 2]) << np.uint32(2))
    )
    return key.astype(np.int64)


def robust_border_np(pos: np.ndarray, outlier_slots: int = 0):
    """NumPy mirror of ``bh_fused.robust_box``: centre at the coordinate
    median, border = 2 * the (K+1)-th largest Chebyshev distance * 1.0001.
    Returns (center, border, outlier_index)."""
    n = pos.shape[0]
    k = int(outlier_slots) or max(128, n // 512)
    k = min(k, n - 1)
    pos32 = pos.astype(np.float32)
    center = np.median(pos32, axis=0)
    d = np.max(np.abs(pos32 - center), axis=1)
    idx = np.argpartition(d, n - 1 - k)[n - 1 - k:]
    order = idx[np.argsort(d[idx])[::-1]]
    border = 2.0 * d[order[k]] * 1.0001
    return center, float(border), order[:k]


def estimate_bh_costs(
    pos: np.ndarray,
    mass: np.ndarray,
    *,
    border: float,
    center=None,
    theta: float = 0.5,
    leaf_cap: int = 64,
    group_size: int = 1024,
    depths=(4, 5, 6, 7, 8),
    sample_groups: int = 64,
    persistent: bool = False,
    group_chunk: int = 8,
):
    """Price each candidate terminal level `d` in predicted milliseconds.

    Returns {d: {"near", "far", "pops", "pred_ms"}}: the estimated staged
    near bodies and far children per evaluation, the frontier pops,
    extrapolated from the group sample, and the priced sum with the
    per-node table term (the rebuild if `persistent`, else the build).
    """
    from nbody_tpu_torch.ops.morton import auto_split_level

    n = pos.shape[0]
    b = int(group_size)
    max_d = max(depths)
    pos32 = np.asarray(pos, np.float32)
    if center is not None:
        pos32 = pos32 - np.asarray(center, np.float32)
    keys = np_morton_encode(pos32, border, max_d)
    order = np.argsort(keys, kind="stable")
    ps = pos32[order]
    ks = keys[order]
    ms = np.asarray(mass, np.float32)[order]

    # groups as ops.morton.group_ranges makes them: B-body chunks that
    # never cross split-level cell boundaries (cells hold ~2B bodies)
    sl = auto_split_level(n, b)
    cell_sl = ks >> (3 * (max_d - min(sl, max_d)))
    first_in_cell = np.concatenate(([True], cell_sl[1:] != cell_sl[:-1]))
    idx = np.arange(n)
    cell_start = np.maximum.accumulate(np.where(first_in_cell, idx, 0))
    new_group = first_in_cell | ((idx - cell_start) % b == 0)
    gstarts = np.flatnonzero(new_group)
    gends = np.concatenate((gstarts[1:], [n]))
    n_groups = len(gstarts)
    stride = max(1, n_groups // max(1, sample_groups))
    gsel = np.arange(0, n_groups, stride)
    weight = n_groups / len(gsel)
    glo = np.empty((len(gsel), 3), np.float32)
    ghi = np.empty((len(gsel), 3), np.float32)
    for i, g in enumerate(gsel):
        seg = ps[gstarts[g]:gends[g]]
        glo[i] = seg.min(axis=0)
        ghi[i] = seg.max(axis=0)

    theta_sq = np.float32(theta * theta)
    s = len(gsel)
    # per-level records (classification at l < d does not depend on d)
    near_l = np.zeros(max_d + 1)  # bodies staged near at level l (non-terminal)
    term_l = np.zeros(max_d + 1)  # bodies that would stage if l were terminal
    far_l = np.zeros(max_d + 1)  # far children classified at level l
    pops_l = np.zeros(max_d + 1)  # opened-cell volume (classify work)

    # paropen[s, c]: did group s open cell c's parent?  level 0 = root
    paropen = np.ones((s, 1), bool)
    parent_keys = np.zeros(1, np.int64)
    for level in range(1, max_d + 1):
        pref = ks >> (3 * (max_d - level))
        bound = np.flatnonzero(np.diff(pref)) + 1
        starts = np.concatenate(([0], bound))
        cells = pref[starts]
        cnt = np.diff(np.concatenate((starts, [n])))
        # max() guards all-massless cells (the robust mode's zero-massed
        # outliers)
        wsum = np.maximum(np.add.reduceat(ms, starts), np.float32(1e-30))
        com = np.add.reduceat(ps * ms[:, None], starts) / wsum[:, None]
        pcol = np.searchsorted(parent_keys, cells >> 3)
        po = paropen[:, pcol]  # (s, C)
        bsq = np.float32((border / 2.0**level) ** 2)
        opened = np.zeros((s, cnt.shape[0]), bool)
        for j0 in range(0, s, group_chunk):
            j1 = min(j0 + group_chunk, s)
            dd = [com[None, :, a] - np.clip(com[None, :, a], glo[j0:j1, None, a],
                                            ghi[j0:j1, None, a]) for a in range(3)]
            d2 = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]
            pj = po[j0:j1]
            far = (theta_sq * d2 > bsq) & pj
            notfar = ~far & pj
            near = notfar & (cnt[None, :] <= leaf_cap)
            far_l[level] += far.sum()
            near_l[level] += (near * cnt[None, :]).sum()
            term_l[level] += (notfar * cnt[None, :]).sum()
            opened[j0:j1] = notfar & ~near
            pops_l[level] += pj.sum()
        paropen = opened
        parent_keys = cells

    out = {}
    for d in sorted(depths):
        near = (near_l[1:d].sum() + term_l[d]) * weight
        far = far_l[1:d + 1].sum() * weight
        pops = pops_l[1:d + 1].sum() * weight
        nodes = (8 ** (d + 1) - 1) // 7
        node_ns = NS_PER_TABLE_NODE if persistent else NS_PER_BUILD_NODE
        pred = ((near + far) * NS_PER_SOURCE + (pops / 128.0) * NS_PER_POP
                + nodes * node_ns) * 1e-6
        out[d] = {"near": near, "far": far, "pops": pops, "pred_ms": pred}
    return out


def choose_ld(
    pos: np.ndarray,
    mass: np.ndarray,
    *,
    robust: bool = False,
    outlier_slots: int = 0,
    theta: float = 0.5,
    leaf_cap: int = 64,
    group_size: int = 1024,
    persistent: bool = False,
    min_ld: int = 0,
    max_ld: int = 8,
    sample_groups: int = 64,
    verbose: bool = False,
):
    """Pick the terminal grid level for this input by pricing.  Mirrors
    the robust box (median centre, K-outlier-trimmed border, zero-massed
    outliers) when `robust`, else the plain bounding cube.  Returns (ld,
    costs)."""
    from nbody_tpu_torch.ops.bh_fused import auto_ld

    n = pos.shape[0]
    pos = np.asarray(pos, np.float32)
    mass_w = np.asarray(mass, np.float32)
    center = None
    if robust:
        center, border, out_idx = robust_border_np(pos, outlier_slots)
        mass_w = mass_w.copy()
        mass_w[out_idx] = 0.0
    else:
        border = 2.0 * float(np.max(np.abs(pos)))
    border = max(border, 1e-30)  # degenerate (coincident) inputs
    base = auto_ld(n)
    lo = max(2, min_ld or base)
    hi = max(lo, min(max_ld, base + 2 if not robust else max_ld))
    depths = tuple(range(lo, hi + 1))
    if len(depths) == 1:
        return depths[0], {}
    costs = estimate_bh_costs(
        pos, mass_w, border=border, center=center, theta=theta, leaf_cap=leaf_cap,
        group_size=group_size, depths=depths, sample_groups=sample_groups,
        persistent=persistent,
    )
    best = min(costs, key=lambda d: costs[d]["pred_ms"])
    if verbose:
        for d in sorted(costs):
            c = costs[d]
            print(f"  ld {d}: near {c['near']:.3e} far {c['far']:.3e} "
                  f"pred {c['pred_ms']:.1f} ms" + ("  <- pick" if d == best else ""))
    return best, costs


# The probe costs seconds at 1M bodies; its pick is a pure function of the
# input and the pricing config, so it is memoised on disk, keyed on a
# strided sample of the input, the config and the unit costs.

def autold_cache_path() -> str:
    """$NBODY_TPU_TORCH_CACHE/autold_cache.json, by default under
    $XDG_CACHE_HOME (or ~/.cache)/nbody_tpu_torch."""
    base = os.environ.get(
        "NBODY_TPU_TORCH_CACHE",
        os.path.join(os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
                     "nbody_tpu_torch"),
    )
    return os.path.join(base, "autold_cache.json")


def _autold_key(pos, mass, kwargs) -> str:
    n = pos.shape[0]
    stride = max(1, n // 4096)
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(pos[::stride], np.float32).tobytes())
    h.update(np.ascontiguousarray(mass[::stride], np.float32).tobytes())
    cfg = {k: kwargs.get(k) for k in sorted(kwargs) if k != "verbose"}
    h.update(repr((_CACHE_SCHEMA, n, NS_PER_SOURCE, NS_PER_POP, NS_PER_TABLE_NODE,
                   NS_PER_BUILD_NODE, cfg)).encode())
    return h.hexdigest()


def choose_ld_cached(pos: np.ndarray, mass: np.ndarray, **kwargs):
    """``choose_ld`` with an on-disk memo.  Returns (ld, cached), `cached`
    saying whether the probe was skipped.  A miss runs the probe and
    appends; a cache that cannot be read or written is probed around, as
    the memo is an optimisation.  NBODY_TPU_TORCH_NO_CACHE turns it off."""
    pos = np.asarray(pos, np.float32)
    mass = np.asarray(mass, np.float32)
    if os.environ.get("NBODY_TPU_TORCH_NO_CACHE"):
        return choose_ld(pos, mass, **kwargs)[0], False
    path = autold_cache_path()
    key = _autold_key(pos, mass, kwargs)
    table: dict = {}
    try:
        with open(path) as f:
            table = json.load(f)
        if key in table:
            return int(table[key]), True
    except (OSError, ValueError):
        table = {}
    ld, _ = choose_ld(pos, mass, **kwargs)
    try:
        table[key] = int(ld)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(table, f)
        os.replace(tmp, path)
    except OSError:
        pass
    return int(ld), False
