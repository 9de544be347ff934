"""`exact_gram_roofline.stacked_search` on synthetic trace events: the
Gram kernel's launches, an x side and an h side an epoch, against the
bound of each side at the cell's sizes; nothing where no launch ran."""

from types import SimpleNamespace

import pytest

from portbench import roofline, spec, trace

NAME = 'exact_gram_roofline.stacked_search'
SIZES = {'B': 4224, 'T': 10, 'I': 1, 'H': 40}


def _side(cands, dim, shared):
    """One side's bound by hand: pre and targets (S, T, 4H, B), the design
    once, the outputs once; the symmetric half and bvec's multiply-adds."""
    cols, rows = 160, 42240
    nbytes = 4 * (2 * cands * cols * rows
                  + (1 if shared else cands) * dim * rows
                  + cands * cols * (dim * dim + dim))
    flops = 2 * cands * cols * rows * (dim * (dim + 1) // 2 + dim)
    return roofline.bound(nbytes, flops)[0]


def test_exact_gram_roofline_counts_the_launches_it_finds():
    # Two epochs: each an x-side launch of 1 ms and an h-side launch of
    # 10 ms, each with its 0.1 ms reduction; one other kernel.
    name = '(anonymous namespace)::exact_gram_kernel(GramArgs)'
    red = 'void (anonymous namespace)::exact_gram_reduce_kernel(float*)'
    device = []
    t = 0.0
    for _ in range(2):
        for ms in (1.0, 10.0):
            device += [(t, t + ms * 1e3, name),
                       (t + ms * 1e3, t + ms * 1e3 + 100, red)]
            t += ms * 1e3 + 200
    device.append((t, t + 50, 'elementwise'))
    ctx = SimpleNamespace(trace=trace.summarize(device, [], 0, 1e-4),
                          width=27, sizes=SIZES)
    got = spec.reader('metrics', NAME)(ctx)
    pair = _side(27, 1, True) + _side(27, 40, False)
    assert got == pytest.approx(100.0 * 2 * pair / 22.4e-3)
    assert 0 < got <= 100
    ctx.trace = trace.summarize(device[-1:], [], 0, 1e-4)
    assert spec.reader('metrics', NAME)(ctx) is None
    ctx.trace = None
    assert spec.reader('metrics', NAME)(ctx) is None
