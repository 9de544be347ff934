"""The fused stacked sweep's share of its roofline in the stacked search
(`admm_lstm_torch/csrc/stacked_sweep.cu`): an epoch's `stacked_sweep_kernel`
launch and, before it, one `stacked_resmax_kernel` launch per upper layer,
against the least time the bytes they must move take.  Per t, candidate,
column and hidden row (every layer of width H) the sweep reads layer 0's
old f, g, c, h and 6 duals and each upper layer's old i, f, g, o, c, h,
6 duals, 4 z and 4 z duals, and writes 6 gates and 5 duals a layer and
each upper layer's 4 z and 4 z duals, row 0's zeros too; the bounds'
pass reads each upper layer's i, f, g, o, their duals and 4 z at t = 1..T.
The share counts the sweep launches that the trace holds, each at the
cell's full width (`ctx.width` candidates): the search runs them as one
group, and a search halved into smaller groups would read too high (the
run logs its group count).  None where the kernels never launched."""
from portbench import roofline

SWEEP = ('stacked_sweep_kernel',)
KERNELS = SWEEP + ('stacked_resmax_kernel',)


def launch_bytes(sizes: dict, cands: int) -> int:
    """The bytes of one epoch's launches at `sizes` and `cands`
    candidates."""
    steps, upper = sizes['T'], sizes['layers'] - 1
    rows = (steps * (10 + 20 * upper) + (steps + 1) * (11 + 19 * upper)
            + 12 * steps * upper)
    return 4 * cands * sizes['H'] * sizes['B'] * rows


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, _ = ctx.trace.kernels(KERNELS)
    _, launches = ctx.trace.kernels(SWEEP)
    if not launches or seconds <= 0:
        return None
    bound = roofline.bound(launch_bytes(ctx.sizes, ctx.width), 0)[0]
    return 100.0 * bound * launches / seconds
