"""The candidate axis of the port's stacked variant
(admm_lstm_torch/variants/stacked.py): S independent stacks in one batched
epoch, as `tune.search_rho_stacked` trains them, against the JAX
package's `jax.vmap` of its stacked epoch and against the port's own
epochs alone, on the CPU.

Inputs are the JAX package's seeded synthetic problem; the weights are
JAX's `init_stacked(PRNGKey(0))`, carried across as numpy arrays, and the
same numpy noise moves both packages' slabs off the forward pass."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_lstm_tpu import ADMMConfig as JConfig
from admm_lstm_tpu.core.state import Penalties as JPenalties
from admm_lstm_tpu.core.step import rules_for as j_rules_for
from admm_lstm_tpu.data.synthetic import load as synth
from admm_lstm_tpu.params import parameter_set as j_parameter_set
from admm_lstm_tpu.variants import stacked as js
from admm_lstm_torch.core.state import penalties_from_vectors
from admm_lstm_torch.core.step import rules_for
from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.solvers import prox_linear
from admm_lstm_torch.tune import candidate_grid
from admm_lstm_torch.utils.config import ADMMConfig
from admm_lstm_torch.variants import stacked as ts

torch.set_num_threads(1)

S, T, B = 3, 6, 48
HIDDENS = {2: (5, 4), 3: (4, 3, 3)}
# One batched epoch against jax.vmap of JAX's: the same f32 math summed
# in another order, each leaf within this share of its scale
# (_assert_close).
JAX_REL = 1e-4
# The batched epochs against each candidate's epochs alone: the same f32
# math, the products batched (leaves as above; the losses relative).
ALONE_REL = 1e-6
EPOCHS = 3
# rho_z per candidate, around the 'Stacked' tuning's 1.0.
RHO_Z = np.asarray([0.5, 1.0, 2.0], np.float32)


@pytest.fixture(scope='module')
def data():
    return synth(batch=B, seq_len=T, input_size=2, output_size=1,
                 val_batch=8)


def _weights_of(j_params):
    w = {}
    for k, layer in enumerate(j_params.layers):
        for gi, g in enumerate('ifgo'):
            w[f'l{k}_x2{g}'] = np.array(layer.wx[gi])
            w[f'l{k}_h2{g}'] = np.array(layer.wh[gi])
        w[f'l{k}_wy'] = np.array(layer.wy)
    w['wy'] = np.array(j_params.wy)
    return w


def _states(data, depth, variant):
    """The same S broadcast states in both packages: rho from three far
    apart points of the c, h, y grid, rho_z from RHO_Z, and the gate,
    dual and z slabs moved by the same noise (row 0 stays zero)."""
    tx = data[0]
    table = candidate_grid(parameter_set('Stacked'))[[0, 13, 26]]
    jp = js.init_stacked(jax.random.PRNGKey(0), 2, HIDDENS[depth], 1)
    cfg, j_cfg = ADMMConfig(variant=variant), JConfig(variant=variant)
    base = ts.init_stacked_state(
        ts.stacked_params_from_dict(_weights_of(jp)), torch.from_numpy(tx),
        parameter_set('Stacked'), cfg)
    state = ts.broadcast_stacked_state(base, S, penalties_from_vectors(table),
                                       RHO_Z)
    j_state = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (S,) + a.shape),
        js.init_stacked_state(jp, jnp.asarray(tx),
                              j_parameter_set('Stacked'), j_cfg))
    j_state = j_state._replace(
        rho=JPenalties(*(jnp.asarray(table[:, k]) for k in range(7))),
        rho_z=jnp.asarray(RHO_Z))
    rng = np.random.default_rng(depth)

    def noisy(t, j, scale):
        noise = (rng.standard_normal(t.shape) * scale).astype(np.float32)
        noise[:, 0] = 0.0
        return t + torch.from_numpy(noise), j + noise

    gates, duals, j_gates, j_duals = [], [], [], []
    for g, d, jg, jd in zip(state.gates, state.duals, j_state.gates,
                            j_state.duals):
        pg = [noisy(a, b, 0.05) for a, b in zip(g[:6], jg[:6])]
        pd = [noisy(a, b, 0.01) for a, b in zip(d[:6], jd[:6])]
        gates.append(g._replace(**dict(zip('ifgoch', (p[0] for p in pg)))))
        j_gates.append(jg._replace(**dict(zip('ifgoch', (p[1] for p in pg)))))
        duals.append(d._replace(**dict(zip('ifgoch', (p[0] for p in pd)))))
        j_duals.append(jd._replace(**dict(zip('ifgoch', (p[1] for p in pd)))))
    zs = [noisy(a, b, 0.05) for a, b in zip(state.zs, j_state.zs)]
    zds = [noisy(a, b, 0.01) for a, b in zip(state.zduals, j_state.zduals)]
    state = state._replace(gates=tuple(gates), duals=tuple(duals),
                           zs=tuple(p[0] for p in zs),
                           zduals=tuple(p[0] for p in zds))
    j_state = j_state._replace(gates=tuple(j_gates), duals=tuple(j_duals),
                               zs=tuple(p[1] for p in zs),
                               zduals=tuple(p[1] for p in zds))
    return cfg, j_cfg, state, j_state


def _inputs(data):
    x, y, vx, vy = (torch.from_numpy(a) for a in data)
    x_im = x.permute(1, 2, 0).contiguous()
    xall = torch.cat([x_im, vx.permute(1, 2, 0)], dim=-1).contiguous()
    return x_im, y.T.contiguous(), xall, vy.T.contiguous()


def _leaves(state):
    """(name, array) of every leaf of a stacked state, either package."""
    out = [('wy', state.params.wy)]
    for k, layer in enumerate(state.params.layers):
        out += [(f'layer{k}.{f}', getattr(layer, f)) for f in ('wx', 'wh')]
        out += [(f'gates{k}.{f}', getattr(state.gates[k], f))
                for f in 'ifgocha']
        out += [(f'duals{k}.{f}', getattr(state.duals[k], f))
                for f in 'ifgochy']
    for k in range(len(state.zs)):
        out += [(f'z{k + 1}', state.zs[k]),
                (f'zdual{k + 1}', state.zduals[k])]
    out += [(f'rho.{f}', getattr(state.rho, f)) for f in 'ifgochy']
    out.append(('rho_z', state.rho_z))
    return [(n, np.asarray(a, np.float32)) for n, a in out]


def _assert_close(got, want, rel, label, candidates=range(S)):
    """Every leaf of every candidate within `rel` of that candidate's
    scale of the leaf: its largest magnitude, and for a dual that plus
    rho times its primal's (a dual's ascent adds rho times the primal's
    residual, and so rho times the primal's rounding)."""
    want_leaves = dict(_leaves(want))
    rho = {f: want_leaves[f'rho.{f}'] for f in 'ifgochy'}
    primal_of = {f'duals{k}.{f}': (f'gates{k}.{"a" if f == "y" else f}', f)
                 for k in range(len(want.gates)) for f in 'ifgochy'}
    primal_of.update({f'zdual{k}': (f'z{k}', 'z')
                      for k in range(1, len(want.gates))})
    rho['z'] = want_leaves['rho_z']
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert a.shape == b.shape, (label, name)
        for s in candidates:
            pick = lambda v: v[s] if v.ndim else v
            a_s, b_s = pick(a), pick(b)
            scale = float(np.max(np.abs(b_s)))
            if name in primal_of:
                primal, key = primal_of[name]
                scale += float(pick(rho[key])) * float(
                    np.max(np.abs(pick(want_leaves[primal]))))
            err = float(np.max(np.abs(a_s - b_s)))
            assert err <= rel * scale, (label, name, s, err, scale)


def _epochs(state, data, rules, count=EPOCHS):
    x_im, y_im, _, _ = _inputs(data)
    for _ in range(count):
        state = ts.stacked_admm_step_im(state, x_im, y_im, rules)
    return state


def _losses(state, data):
    x_im, y_im, xall, vy_im = _inputs(data)
    return torch.stack(ts.stacked_train_val_mse_im(state.params, xall, y_im,
                                                   vy_im), dim=-1)


@pytest.mark.parametrize('variant', ['fast', 'no_dual_y'])
@pytest.mark.parametrize('depth', sorted(HIDDENS))
def test_torch_batched_stacked_epoch_matches_jax_vmap(data, depth, variant):
    """One batched stacked epoch against jax.vmap of JAX's
    stacked_admm_step, per-candidate rho and rho_z."""
    cfg, j_cfg, state, j_state = _states(data, depth, variant)
    j_rules = j_rules_for(j_cfg)
    tx, ty = jnp.asarray(data[0]), jnp.asarray(data[1])
    want = jax.jit(jax.vmap(lambda s: js.stacked_admm_step(
        s, tx, ty, j_rules)))(j_state)
    got = _epochs(state, data, rules_for(cfg), 1)
    assert got.candidates == S and got.epoch == 1
    assert got.rho_z.shape == (S,)
    _assert_close(got, want, JAX_REL, f'depth {depth} {variant}')


@pytest.mark.parametrize('variant', ['fast', 'no_dual_y'])
@pytest.mark.parametrize('depth', sorted(HIDDENS))
def test_torch_batched_stacked_epochs_match_epochs_alone(data, depth,
                                                         variant):
    """EPOCHS batched epochs against each candidate's epochs alone: every
    leaf, and the train and validation losses, within ALONE_REL."""
    cfg, _, state, _ = _states(data, depth, variant)
    rules = rules_for(cfg)
    batched = _epochs(state, data, rules)
    losses = _losses(batched, data)
    assert losses.shape == (S, 2)
    alone = [_epochs(ts.take(state, s), data, rules) for s in range(S)]
    for s, one in enumerate(alone):
        assert one.candidates is None and one.rho_z.dim() == 0
        got = ts.take(batched, slice(s, s + 1))
        want = ts.broadcast_stacked_state(one, 1, rho_z=[float(one.rho_z)])
        _assert_close(got, want, ALONE_REL, f'candidate {s}', [0])
        np.testing.assert_allclose(losses[s].numpy(),
                                   _losses(one, data).numpy(),
                                   rtol=ALONE_REL)
    assert [o.epoch for o in alone] == [batched.epoch] * S == [EPOCHS] * S


@pytest.mark.parametrize('depth', sorted(HIDDENS))
def test_torch_batched_stacked_candidates_do_not_couple(data, depth):
    """Permuting the candidates, or training each as a batch of one,
    leaves every candidate's numbers as they were: no max, trace or sum
    reaches across candidates (each candidate's z-prox bound is its own)."""
    cfg, _, state, _ = _states(data, depth, 'fast')
    rules = rules_for(cfg)
    batched = _epochs(state, data, rules)
    perm = [2, 0, 1]
    permuted = _epochs(ts.take(state, perm), data, rules)
    back = ts.take(permuted, [perm.index(s) for s in range(S)])
    _assert_close(back, batched, ALONE_REL, 'permuted')
    for s in range(S):
        single = _epochs(ts.take(state, slice(s, s + 1)), data, rules)
        _assert_close(single, ts.take(batched, slice(s, s + 1)), ALONE_REL,
                      f'candidate {s} alone in a batch', [0])


def test_torch_batched_stacked_nan_candidate_leaves_the_others(data):
    """A candidate that diverges (rho_y NaN) ends non-finite and leaves
    the others equal to a batch without it."""
    cfg, _, state, _ = _states(data, 3, 'fast')
    rules = rules_for(cfg)
    rho_y = state.rho.y.clone()
    rho_y[1] = float('nan')
    with_nan = _epochs(state._replace(rho=state.rho._replace(y=rho_y)),
                       data, rules, 2)
    without = _epochs(ts.take(state, slice(0, 3, 2)), data, rules, 2)
    assert not bool(torch.isfinite(with_nan.gates[-1].a[1]).all())
    assert not bool(torch.isfinite(_losses(with_nan, data)[1]).any())
    kept = ts.take(with_nan, slice(0, 3, 2))
    for (name, a), (_, b) in zip(_leaves(kept), _leaves(without)):
        assert np.isfinite(a).all(), name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_torch_batched_stacked_epoch_host_reads(data, monkeypatch):
    """A batched stacked epoch reads the host once, for the final-h
    search's one block of tests for all S, and so no more often than any
    candidate's epoch alone, whose loop reads once a test."""
    cfg, _, state, _ = _states(data, 2, 'fast')
    rules = rules_for(cfg)
    reads, blocks = [], []
    real_bool = torch.Tensor.__bool__
    real_search = prox_linear.doubling_search

    def counting_bool(t):
        reads.append(1)
        return real_bool(t)

    def counting_search(*a, **k):
        theta, k_done = real_search(*a, **k)
        blocks.append(k_done // prox_linear.BLOCK_K)
        return theta, k_done

    monkeypatch.setattr(torch.Tensor, '__bool__', counting_bool)
    monkeypatch.setattr(prox_linear, 'doubling_search', counting_search)

    def epoch_reads(st):
        reads.clear()
        blocks.clear()
        _epochs(st, data, rules, 1)
        return len(reads), list(blocks)

    batched_reads, batched_blocks = epoch_reads(state)
    alone = [epoch_reads(ts.take(state, s)) for s in range(S)]
    assert batched_blocks == [1] and batched_reads == 1
    assert all(a[1] == [] and a[0] >= batched_reads for a in alone)


def test_torch_stacked_state_broadcast_take_unstack(data):
    """broadcast_stacked_state gives every leaf a contiguous copy of its
    own (rho_z (S,) where given, the shared 0-d one where not); take and
    unstack give back each candidate; the forward takes per-candidate
    weights on shared data."""
    _, _, state, _ = _states(data, 3, 'fast')
    base = ts.take(state, 0)
    shared = ts.broadcast_stacked_state(base, 2)
    assert shared.candidates == 2 and shared.rho_z.dim() == 0
    assert shared.rho.y.shape == (2,) and shared.beta.x.shape == (2, 4)
    for t in (shared.gates[0].h, shared.zs[1], shared.params.wy):
        assert t.is_contiguous()
    shared.gates[0].h[0].add_(1.0)
    assert not torch.equal(shared.gates[0].h[0], shared.gates[0].h[1])
    assert torch.equal(base.gates[0].h, ts.take(state, 0).gates[0].h)
    parts = ts.unstack(state)
    assert len(parts) == S
    assert [float(p.rho_z) for p in parts] == RHO_Z.tolist()
    x_im, _, _, _ = _inputs(data)
    batched = ts.stacked_forward_im(state.params, x_im)
    for s, part in enumerate(parts):
        assert part.candidates is None
        for (name, a), (_, b) in zip(_leaves(part),
                                     _leaves(ts.take(state, s))):
            np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_allclose(
            batched[s].numpy(),
            ts.stacked_forward_im(part.params, x_im).numpy(),
            rtol=ALONE_REL, atol=1e-7)


def test_torch_profile_epoch_takes_stacked_candidates(data):
    """profile_epoch.py --layers 2 --candidates S profiles the stacked
    state broadcast over the first S points of the 'Stacked' grid; the
    arguments pass its checks, and the profiling itself needs the card."""
    from admm_lstm_torch import profile_epoch
    _, _, state, _ = _states(data, 2, 'fast')
    ps = parameter_set('Stacked')
    got = profile_epoch.rho_grid(ts.take(state, 0), ps, 4,
                                 ts.broadcast_stacked_state)
    assert got.candidates == 4 and got.rho_z.dim() == 0
    np.testing.assert_array_equal(torch.stack(list(got.rho), -1).numpy(),
                                  np.resize(candidate_grid(ps), (4, 7)))
    with pytest.raises(SystemExit, match='CUDA card'):
        profile_epoch.main(['--layers', '2', '--hidden', '8',
                            '--candidates', '27'])
