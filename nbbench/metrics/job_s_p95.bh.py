"""``job_s_p95`` of a Barnes-Hut cell, read in the traced run over the
window's jobs that the profiler did not record.  Barnes-Hut's jobs wait on
the host (some 2,000 launches and a dozen host reads a job), and a host
stall of 10-300 ms lands in a few per cent of them: the 95th percentile
falls at the edge of those and swings from run to run by more than an
end-to-end bound may hold, so it is a per-layer metric here."""

from nbbench.metrics.job_s_p95 import read  # noqa: F401
