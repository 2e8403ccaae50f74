"""K1 (``csrc/allpairs.cu``, ``allpairs_kernel``): 19 n^2 flops an
evaluation at 67 TFLOP/s f32, over K1's device time in the traced window.
Evaluations: the port's K1 launch counter over the traced jobs."""

from nbbench.metrics._roofline import share
from nbbench.work import allpairs


def read(ctx):
    evals = ctx.counters.get("k1_launches", 0)
    return share(ctx, r"\ballpairs_kernel\b", evals * allpairs.flops(ctx.n, ctx.n), "f32")
