"""The Cholesky kernels' share of their roofline in the stacked search
(`admm_lstm_torch/csrc/cholesky.cu`): layer 0's exact stage solves its
S x 4H systems a side in one launch, the x side's (S 4H, 1) in
`warp_chol_kernel` and the h side's (S 4H, H) in `blocked_solve_kernel`
(32 < H <= 128).  The bound of each launch is roofline.solve_bound at its
shape; the share counts the launches that the trace holds.  None where
neither kernel launched."""
from portbench import roofline

X_SIDE = ('warp_chol_kernel',)
H_SIDE = ('blocked_solve_kernel',)


def read(ctx):
    if ctx.trace is None:
        return None
    systems = ctx.width * 4 * ctx.sizes['H']
    x_s, x_n = ctx.trace.kernels(X_SIDE)
    h_s, h_n = ctx.trace.kernels(H_SIDE)
    if not x_n + h_n or x_s + h_s <= 0:
        return None
    bound = (x_n * roofline.solve_bound(systems, ctx.sizes['I'])[0]
             + h_n * roofline.solve_bound(systems, ctx.sizes['H'])[0])
    return 100.0 * bound / (x_s + h_s)
