"""The glue's device time a step: every kernel, copy and fill of the traced
window other than the hand-written kernels K1 (forward), K2 (QCQP backward)
and K4 (QP backward): Ruiz equilibration, the radius map, _grad_P, the
radius factors, the staging copies and the step's two counts, summed inside
its graph, over the steps traced."""

from portbench.metrics.k1_ms import is_k1
from portbench.metrics.k4_ms import is_k4

K2_TAG = "qcqp_bwd_kernel"


def read(ctx):
    s = ctx.trace.device_s(lambda name: not (is_k1(name) or is_k4(name) or K2_TAG in name))
    return 1e3 * s / ctx.steps if s > 0 and ctx.steps else None
