"""The Gauss-Seidel sweep kernel's share of its roofline: one launch per
(batched) epoch over the T - 1 interior steps of every instance."""
from portbench import readers, roofline

KERNELS = ('interior_sweep_kernel',)


def read(ctx):
    s = ctx.sizes
    bound = roofline.sweep_bound(s['T'] - 1, s['H'], s['B'], ctx.width)[0]
    return readers.roofline_share(ctx, KERNELS, 1, bound)
