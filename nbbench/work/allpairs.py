"""Operations of an all-pairs force evaluation, a closed formula: 19 for
each ordered pair of targets and sources (3 subtractions, 3 multiplies and
3 adds for |d|^2 + eps2, the reciprocal square root, 3 multiplies for the
cube times G·m, and 3 fused multiply-adds into the sum, counted as 6), the
count ``chip_smoke.py``'s bounds use.  The bytes (the inputs read once, the
output written once) are far below the operations' time at the card's
rates, so the bound is the operations'."""

FLOPS_PER_PAIR = 19


def flops(targets: int, sources: int) -> int:
    return FLOPS_PER_PAIR * targets * sources


def bound_seconds(targets: int, sources: int, peak_flops: float) -> float:
    return flops(targets, sources) / peak_flops
