"""K4 (``csrc/allpairs_f64.cu``, ``allpairs_f64_kernel``): 19 n^2 flops an
evaluation at 34 TFLOP/s fp64, over K4's device time in the traced window.
Evaluations: the port's K4 launch counter over the traced jobs."""

from nbbench.metrics._roofline import share
from nbbench.work import allpairs


def read(ctx):
    evals = ctx.counters.get("k4_launches", 0)
    return share(ctx, r"\ballpairs_f64_kernel\b", evals * allpairs.flops(ctx.n, ctx.n), "f64")
