"""Barnes-Hut group x interaction-list evaluation through the hand-written
CUDA kernel K7 — counterpart of ``nbody_tpu/ops/barneshut.py``'s
``_eval_lists_pallas`` (the Pallas ``_group_kernel``).

``eval_lists`` (f32) and ``eval_lists_f64`` (native fp64) wrap the two
entry points of ``nbody_tpu_torch/csrc/group_lists.cu``.  A CPU tensor
goes to the plain version, ``eval_lists_reference`` (the port of JAX's
``_eval_lists_jnp``); a CUDA tensor launches the kernel or raises.
Nothing falls back.  Each wrapper's ``.launches`` counts its kernel's
launches.

JAX's Pallas path casts to f32 whatever the run's dtype
(``barneshut.py:87-90``); the fp64 entry point serves ``--dtype f64`` and
is held to JAX's jnp path, which evaluates in f64.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.ops.cuda_exhaustive import check_tensor, fewest_split

# (bodies x list entries) pairs the plain evaluator computes at once
_PAIR_BLOCK = 1 << 22


def eval_lists_reference(pos_groups: torch.Tensor, lists: torch.Tensor,
                         lengths: torch.Tensor | None = None, *,
                         eps2: float) -> torch.Tensor:
    """The plain version of K7: accelerations (G, B, 3) of every group slot
    of `pos_groups` (G, B, 3) against its group's list `lists` (G, M, 4)
    rows [x y z G·m], in pos_groups' dtype (``_eval_lists_jnp``: rsqrt in
    f32, r2 ** -0.5 in f64).  It runs the full M, as JAX does: the padded
    tail has G·m = 0 and adds exact zeros; `lengths` is taken for the
    kernel's signature.  Groups go in blocks of bounded size."""
    del lengths
    n_groups, b, _ = pos_groups.shape
    m = lists.shape[1]
    dtype = pos_groups.dtype
    lv = lists.to(dtype)
    out = torch.empty((n_groups, b, 3), dtype=dtype, device=pos_groups.device)
    gc = max(1, min(n_groups, _PAIR_BLOCK // max(1, b * m)))
    for g0 in range(0, n_groups, gc):
        p, lg = pos_groups[g0:g0 + gc], lv[g0:g0 + gc]
        d = lg[:, None, :, :3] - p[:, :, None, :]  # (gc, B, M, 3)
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2] + eps2
        inv_r = torch.rsqrt(r2) if dtype == torch.float32 else r2 ** -0.5
        w = lg[:, None, :, 3] * (inv_r * inv_r * inv_r)
        out[g0:g0 + gc] = torch.einsum("gbm,gbmd->gbd", w, d)
    return out


def _check(pos_groups, lists, lengths, dtype: torch.dtype):
    device = pos_groups.device
    check_tensor("pos_groups", pos_groups, (-1, -1, 3), device, dtype)
    g, b = pos_groups.shape[:2]
    check_tensor("lists", lists, (g, -1, 4), device, dtype)
    check_tensor("lengths", lengths, (g,), device, torch.int32)
    if max(b, lists.shape[1]) > 2**31 - 1:
        raise ValueError("eval_lists: B or M exceeds the kernel's C int")


# both entries' blocks: 128 threads of 4 slots, four resident an SM
K7_THREADS, K7_PER_THREAD, K7_BLOCKS_PER_SM = 128, 4, 64


def k7_split(g: int, b: int, sms: int) -> int:
    """K7's list slices per block (both entries) for g groups of b slots on
    a card of `sms` SMs: the fewest that give every SM K7_BLOCKS_PER_SM
    blocks, 16 rounds of its four resident ones, so that the groups'
    uneven list lengths even out (on 132 SMs: 8 at 100k bodies, 4 at 1M;
    PERF.md)."""
    return fewest_split(lambda s: g * -(-b // (K7_THREADS // s * K7_PER_THREAD)),
                        K7_BLOCKS_PER_SM * sms)


def launch(lib, pos_groups, lists, lengths, stream, *, eps2: float, split: int = 1):
    """Call K7's launcher in `lib` for pos_groups' dtype on checked
    tensors; returns (cudaError_t, accelerations (G, B, 3)).  `split` is
    the number of list slices a block.  The tensors' pointers go to the
    kernel as they are, so the CPU emulation of the kernel source takes
    the same call."""
    g, b, _ = pos_groups.shape
    out = torch.empty_like(pos_groups)
    entry = (lib.nbody_group_lists_f64 if pos_groups.dtype == torch.float64
             else lib.nbody_group_lists_f32)
    err = entry(pos_groups.data_ptr(), lists.data_ptr(), lengths.data_ptr(), g, b,
                lists.shape[1], float(eps2), split, out.data_ptr(), stream)
    return err, out


def _kernel(pos_groups, lists, lengths, eps2: float, split: int) -> torch.Tensor:
    """Launch K7 on checked CUDA tensors with `split` list slices a block,
    or 0 for ``k7_split``'s pick for this card; raise on a launch error."""
    device = pos_groups.device
    if device.type != "cuda":
        raise ValueError(f"no interaction-list kernel for device {device}")
    if lists.data_ptr() % 16:
        raise ValueError("lists: the kernel reads 16-byte vector rows, so it must be "
                         "16-byte aligned")
    from nbody_tpu_torch.ops import _cuda

    g, b, _ = pos_groups.shape
    split = split or k7_split(g, b, _cuda.sm_count(device))
    kernels = _cuda.library()
    with torch.cuda.device(device):
        err, out = launch(kernels.lib, pos_groups, lists, lengths,
                          _cuda.stream_handle(device), eps2=eps2, split=split)
    kernels.check(err, f"group_lists kernel ({pos_groups.dtype}, groups "
                       f"{pos_groups.shape[0]}, B {pos_groups.shape[1]}, M "
                       f"{lists.shape[1]}, list slices {split})")
    return out


def eval_lists(pos_groups: torch.Tensor, lists: torch.Tensor, lengths: torch.Tensor,
               *, eps2: float, _split: int = 0) -> torch.Tensor:
    """f32 accelerations (G, B, 3) of every slot of `pos_groups` (G, B, 3)
    against its group's first lengths[g] rows of `lists` (G, M, 4) [x y z
    G·m] (the rest must have G·m = 0, as the traversals write them).
    `_split` forces the kernel's number of list slices a block, for the
    card tests and chip_smoke.py's sweep only (0, as every caller of the
    port leaves it: ``k7_split``'s pick for this card)."""
    _check(pos_groups, lists, lengths, torch.float32)
    if pos_groups.device.type == "cpu":
        return eval_lists_reference(pos_groups, lists, lengths, eps2=eps2)
    out = _kernel(pos_groups, lists, lengths, eps2, _split)
    eval_lists.launches += 1
    return out


eval_lists.launches = 0


def eval_lists_f64(pos_groups: torch.Tensor, lists: torch.Tensor, lengths: torch.Tensor,
                   *, eps2: float, _split: int = 0) -> torch.Tensor:
    """The same in native fp64, from f64 bodies and lists, `_split` as
    there."""
    _check(pos_groups, lists, lengths, torch.float64)
    if pos_groups.device.type == "cpu":
        return eval_lists_reference(pos_groups, lists, lengths, eps2=eps2)
    out = _kernel(pos_groups, lists, lengths, eps2, _split)
    eval_lists_f64.launches += 1
    return out


eval_lists_f64.launches = 0
