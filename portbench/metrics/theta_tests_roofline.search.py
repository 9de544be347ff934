"""The weight stages' fused theta tests' share of their roofline
(`admm_lstm_torch/csrc/theta_tests.cu`): a launch reads the stage's
three (S, T, 4H, B) slabs, `pre`, `grad_proj` and `target_w`, once.
One launch tests one block of thetas, and how many blocks a stage takes
depends on the data, so the share counts the launches that the trace
holds.  None where the kernel never launched."""
from portbench import roofline

KERNELS = ('theta_tests_kernel',)


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, launches = ctx.trace.kernels(KERNELS)
    if not launches or seconds <= 0:
        return None
    s = ctx.sizes
    bound = roofline.bound(3 * 4 * ctx.width * s['T'] * 4 * s['H'] * s['B'],
                           0)[0]
    return 100.0 * bound * launches / seconds
