"""The table of peaks: NVIDIA's data-sheet rates of the card, by the name
``torch.cuda.get_device_name()`` gives (SXM part, dense, no sparsity, at its
700 W limit).  A share of a roofline is stated against these."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32": 67e12, "f64": 34e12, "hbm_bytes_per_s": 3.35e12},
}


def peak(kind: str, what: str) -> float | None:
    """The card `kind`'s peak `what` ("f32" or "f64" FLOP/s, or
    "hbm_bytes_per_s"), or None for a card the table does not hold."""
    return PEAKS.get(kind, {}).get(what)
