"""``launches_per_step`` of a Barnes-Hut cell, under a name of its own: the
Barnes-Hut jobs wait on the host, whose stalls spread their runs far wider
than the all-pairs cells', so the end-to-end rate takes a bound of its
own, and what moves it names it."""

from nbbench.metrics.launches_per_step import read  # noqa: F401
