"""The stacked sweep's dispatch and plain version on the CPU: the kernel's
shared-memory plan (kernels/stacked_sweep.stacked_sweep_plan), the epoch's
choice between the kernel and the loop, the packed weights the kernel
reads, and `stacked_sweep_plain` against the epoch that runs it.  The
kernel itself runs only on the card (tests/test_torch_gpu.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from admm_lstm_torch.core.state import Penalties
from admm_lstm_torch.core.step import _per_candidate, rules_for
from admm_lstm_torch.data.synthetic import load as synth
from admm_lstm_torch.kernels import stacked_sweep as ks
from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.utils.config import ADMMConfig
from admm_lstm_torch.variants import stacked


@pytest.mark.parametrize('hiddens, inputs, tb, rows, threads, smem', [
    # (40, 40): wh_0, wx_1, wh_1 of 6,400 floats, wx_0 160, M_0^-1 1,600;
    # 16 columns of h (80 rows), tgt (160) and rhs (40).
    ((40, 40), 1, 16, 2, 320, 4 * (20960 + 16 * 280)),
    ((8, 8), 1, 32, 1, 256, 4 * (864 + 32 * 56)),
    ((6, 5, 4), 2, 32, 1, 192, 4 * (620 + 32 * 41)),
])
def test_plan_accepts_the_stacks(hiddens, inputs, tb, rows, threads, smem):
    plan = ks.stacked_sweep_plan(hiddens, inputs)
    assert (plan.tb, plan.rows, plan.threads, plan.smem) == (
        tb, rows, threads, smem)
    assert plan.w_floats % 4 == 0 and plan.tgt % 4 == 0
    assert plan.smem <= ks.SMEM_PER_BLOCK
    assert plan.minv[-1] == -1 and len(plan.rec) == len(hiddens)


@pytest.mark.parametrize('hiddens, inputs', [
    ((64, 64), 1),          # 214 KB of products and 29 KB of buffers
    ((40, 40), 600),        # wx_0 alone 384 KB
    ((81, 8), 1),           # more rows than 4 a thread in 320 threads
    ((8,) * 4, 1),          # more layers than MAX_LAYERS
    ((8,), 1),              # one layer: the one-layer model's own path
    ((), 1),
])
def test_plan_refuses_what_does_not_fit(hiddens, inputs):
    assert ks.stacked_sweep_plan(hiddens, inputs) is None


@pytest.mark.parametrize('device, precision, has_plan, want', [
    ('cuda', 'highest', True, True),
    ('cpu', 'highest', True, False),
    ('cuda', 'high', True, False),
    ('cuda', 'default', True, False),
    ('cuda', 'highest', False, False),
])
def test_dispatch_by_device_precision_and_plan(device, precision, has_plan,
                                               want):
    plan = ks.stacked_sweep_plan((40, 40), 1) if has_plan else None
    assert ks.use_stacked_kernel(device, precision, plan) is want


def test_packed_weights_are_the_kernels_layout():
    """Each candidate's row holds wh_k and wx_k as [d][j][g] at the plan's
    offsets, then each M^-1 row-major, then zeros."""
    gen = torch.Generator().manual_seed(4)
    params = stacked.init_stacked(gen, 3, (5, 6), 1)
    layers = [lp._replace(wx=torch.stack([lp.wx] * 2),
                          wh=torch.stack([lp.wh] * 2) * torch.tensor(
                              [1.0, 2.0])[:, None, None, None])
              for lp in params.layers]
    m_invs = [torch.randn((2, 5, 5), generator=gen)]
    plan = ks.stacked_sweep_plan((5, 6), 3)
    pack = ks.pack_weights(layers, m_invs, plan)
    assert pack.shape == (2, plan.w_floats)
    for s in range(2):
        for k, h in enumerate((5, 6)):
            d_in = 3 if k == 0 else 5
            rec = pack[s, plan.rec[k]:plan.rec[k] + 4 * h * h]
            inp = pack[s, plan.inp[k]:plan.inp[k] + 4 * d_in * h]
            for g, d, j in ((0, 0, 0), (2, 1, 4), (3, h - 1, h - 1)):
                assert rec[(d * h + j) * 4 + g] == layers[k].wh[s, g, d, j]
            for g, d, j in ((1, 0, 2), (3, d_in - 1, h - 1)):
                assert inp[(d * h + j) * 4 + g] == layers[k].wx[s, g, d, j]
        assert torch.equal(pack[s, plan.minv[0]:plan.minv[0] + 25],
                           m_invs[0][s].reshape(-1))
        assert not pack[s, plan.minv[0] + 25:].any()


@pytest.mark.parametrize('cands', [None, 3])
def test_rho_pack(cands):
    lead = () if cands is None else (cands,)
    rho = Penalties(*(torch.full(lead, float(v)) for v in range(1, 8)))
    out = ks.rho_pack(rho, torch.tensor(9.0))
    assert out.shape == lead + (7,) and out.is_contiguous()
    assert out.reshape(-1, 7)[-1].tolist() == [1, 2, 3, 4, 5, 6, 9]


def _state(cands, hiddens, decay=1.0):
    tx, ty, _, _ = synth(batch=24, seq_len=4, input_size=2, val_batch=4,
                         seed=3)
    x, y = torch.from_numpy(tx), torch.from_numpy(ty)
    params = stacked.init_stacked(torch.Generator().manual_seed(2), 2,
                                  hiddens, 1)
    st = stacked.init_stacked_state(params, x, parameter_set('Stacked'),
                                    ADMMConfig())
    if cands is not None:
        spread = torch.linspace(0.5, 2.0, cands)
        st = stacked.broadcast_stacked_state(
            st, cands, rho=Penalties(*(r * spread for r in st.rho)),
            rho_z=np.linspace(0.6, 1.5, cands))
    rules = dataclasses.replace(rules_for(ADMMConfig()),
                                stacked_dual_decay=decay)
    x_im, y_im = x.permute(1, 2, 0).contiguous(), y.T.contiguous()
    # One epoch first, so that every dual and z dual is nonzero.
    return stacked.stacked_admm_step_im(st, x_im, y_im, rules), x_im, y_im, \
        rules


@pytest.mark.parametrize('cands, hiddens, decay', [
    (None, (6, 5), 1.0), (3, (6, 5), 1.0), (3, (6, 5, 4), 0.9)])
def test_plain_sweep_is_the_epochs_sweep(cands, hiddens, decay):
    """stacked_sweep_plain called on its own gives the slabs of the epoch
    that runs it, bit for bit: every gate (the top layer's h at T, which
    sweep.final writes, aside), dual, z and z dual; and a CPU epoch never
    launches the kernel."""
    st, x_im, y_im, rules = _state(cands, hiddens, decay)
    before = ks.stacked_sweep.launches
    new = stacked.stacked_admm_step_im(st, x_im, y_im, rules)
    assert ks.stacked_sweep.launches == before
    layers = new.params.layers
    m_invs = stacked._sweep_inverses(layers, _per_candidate(st.rho, 2).h,
                                     stacked._view(st.rho_z, 2), 'auto')
    gates, duals, zs, zduals = stacked.stacked_sweep_plain(
        x_im, st.gates, st.duals, st.zs, st.zduals, layers, m_invs, st.rho,
        st.rho_z, decay)
    top = len(hiddens) - 1
    for k in range(len(hiddens)):
        for m in range(6):
            want = new.gates[k][m]
            if k == top and m == 5:
                assert not gates[k][m][..., -1, :, :].any()
                want, got = want[..., :-1, :, :], gates[k][m][..., :-1, :, :]
            else:
                got = gates[k][m]
            assert torch.equal(got, want)
        for m in range(5):
            assert torch.equal(duals[k][m], new.duals[k][m])
    for got, want in zip(zs + zduals, new.zs + new.zduals):
        assert torch.equal(got, want)


def test_kernel_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only: it raises on CPU
    slabs rather than running the loop."""
    st, x_im, _, rules = _state(None, (6, 5))
    layers = st.params.layers
    m_invs = stacked._sweep_inverses(layers, _per_candidate(st.rho, 2).h,
                                     stacked._view(st.rho_z, 2), 'auto')
    with pytest.raises(TypeError, match='CUDA'):
        ks.stacked_sweep(x_im, st.gates, st.duals, st.zs, st.zduals, layers,
                         m_invs, st.rho, st.rho_z, 1.0)


@pytest.mark.parametrize('use_pallas_chol', ['auto', False])
@pytest.mark.parametrize('cands', [None, 3])
def test_cholesky_inverses_match_the_lu(cands, use_pallas_chol):
    """The coupled h solves' M^-1 (L^-T L^-1 from chol_inverse, here its
    plain version) against torch.linalg.inv of M = rho_h I + rho_z
    sum_g wx_g wx_g^T, with and without the candidate axis and with a
    per-candidate rho_z."""
    st, _, _, _ = _state(cands, (6, 5, 4))
    layers = st.params.layers
    rho_h, rz2 = _per_candidate(st.rho, 2).h, stacked._view(st.rho_z, 2)
    chol = stacked._sweep_inverses(layers, rho_h, rz2, use_pallas_chol)
    assert len(chol) == len(layers) - 1
    for k, got in enumerate(chol):
        wx = layers[k + 1].wx
        eye = torch.eye(layers[k].hidden_size)
        want = torch.linalg.inv(rho_h * eye + rz2 * torch.einsum(
            '...gdh,...geh->...de', wx, wx))
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
