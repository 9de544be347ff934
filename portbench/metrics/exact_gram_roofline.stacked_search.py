"""The exact stage's Gram kernel's share of its roofline in the stacked
search (`admm_lstm_torch/csrc/exact_gram.cu`): layer 0's two launches an
epoch, the x side (D = I, one design slab shared by the candidates) and
the h side (D = H, a design slab per candidate), each `exact_gram_kernel`
and its `exact_gram_reduce_kernel`, against the least time their work
takes.  A side's bound is the larger of its bytes over the memory rate
(the pre-activations and targets, (S, T, 4H, B) each, and the design read
once; the Gram stack and first-order term written once) and its
operations over the FP32 rate (2 S 4H T B (D (D + 1) / 2 + D): the
symmetric half of the Gram and the first-order term).  The share counts
the launches that the trace holds, in x and h pairs, each at the cell's
full width (`ctx.width` candidates).  None where the kernel never
launched."""
from portbench import roofline

MAIN = ('exact_gram_kernel',)
KERNELS = MAIN + ('exact_gram_reduce_kernel',)


def side_bound(sizes: dict, cands: int, dim: int, shared: bool) -> float:
    """Seconds: the bound of one side's launch with design width `dim`."""
    cols, rows = 4 * sizes['H'], sizes['T'] * sizes['B']
    nbytes = 4 * (2 * cands * cols * rows
                  + (1 if shared else cands) * dim * rows
                  + cands * cols * (dim * dim + dim))
    flops = 2 * cands * cols * rows * (dim * (dim + 1) // 2 + dim)
    return roofline.bound(nbytes, flops)[0]


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, _ = ctx.trace.kernels(KERNELS)
    _, launches = ctx.trace.kernels(MAIN)
    if not launches or seconds <= 0:
        return None
    pair = (side_bound(ctx.sizes, ctx.width, ctx.sizes['I'], True)
            + side_bound(ctx.sizes, ctx.width, ctx.sizes['H'], False))
    return 100.0 * pair * (launches / 2) / seconds
