"""Data parallelism of the port (admm_lstm_torch.parallel,
api.train_sharded) in one process and through the CLI, on the CPU: the
mesh and its errors, the block layout, a one-rank gloo group bit-equal to
api.train, the batch that the `a` update scales by, and `--mesh`.
The counterparts of tests/test_sharding.py and tests/test_multihost.py
that start several ranks are in test_torch_parallel_ranks.py."""

import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from admm_lstm_torch import api
from admm_lstm_torch.core.consensus import Consensus
from admm_lstm_torch.core.init import init_admm_state
from admm_lstm_torch.core.step import admm_step, rules_for
from admm_lstm_torch.data.synthetic import load as synth
from admm_lstm_torch.models.lstm import params_from_dict
from admm_lstm_torch.parallel import (Mesh, backend_for, gather_state,
                                      initialize_multihost, make_mesh,
                                      pad_batch, shard_batch, shard_range,
                                      shard_state)
from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.solvers import closed_form as cf
from admm_lstm_torch.utils.config import ADMMConfig
from admm_lstm_torch.utils.device import NoCudaDeviceError

torch.set_num_threads(1)
os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _weights(hidden=5, inputs=2, seed=3):
    rng = np.random.default_rng(seed)
    w = {f'x2{g}': (rng.standard_normal((inputs, hidden)) * 0.5)
         .astype(np.float32) for g in 'ifgo'}
    w.update({f'h2{g}': (rng.standard_normal((hidden, hidden)) * 0.4)
              .astype(np.float32) for g in 'ifgo'})
    w['wy'] = (rng.standard_normal((hidden, 1)) * 0.5).astype(np.float32)
    return w


def _leaves(state):
    """Every tensor of an ADMMState, in order."""
    return [t for group in state[:5] for t in group]


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-rank gloo process group in this process, through a FileStore
    under tmp_path."""
    initialize_multihost(f'file://{tmp_path}/store', 1, 0, backend='gloo',
                         timeout=120)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_torch_make_mesh_shapes_and_errors(one_rank_group):
    mesh = make_mesh(device='cpu')
    assert (mesh.shape, mesh.axis_names) == ((1,), ('data',))
    assert (mesh.rank, mesh.world, mesh.backend) == (0, 1, 'gloo')
    assert mesh.device == torch.device('cpu') and mesh.host_group is None
    mesh2 = make_mesh((1, 1), ('data', 'model'), device='cpu')
    assert mesh2.axis_names == ('data', 'model')
    with pytest.raises(ValueError, match='needs 1000 ranks, have 1'):
        make_mesh((1000,), device='cpu')
    with pytest.raises(ValueError, match='axis names'):
        make_mesh((1,), ('data', 'model'), device='cpu')
    assert mesh.describe()['all_reduces'] == 0


def test_torch_make_mesh_outside_a_group_is_one_rank():
    assert not dist.is_initialized()
    mesh = make_mesh(device='cpu')
    assert (mesh.world, mesh.backend, mesh.shape) == (1, None, (1,))
    with pytest.raises(ValueError, match='needs 2 ranks'):
        make_mesh((2,), device='cpu')


def test_torch_backend_rule():
    assert backend_for('cpu', 4) == 'gloo'
    with pytest.raises(ValueError, match='gloo'):
        backend_for('cpu', 2, 'nccl')
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDeviceError):
            backend_for('cuda', 2)
        with pytest.raises(NoCudaDeviceError):
            make_mesh(device='cuda')
        with pytest.raises(NoCudaDeviceError):     # NCCL needs the card
            initialize_multihost('file:///nonexistent/store', 1, 0)
        assert not dist.is_initialized()


@pytest.mark.parametrize('batch,world', [(64, 1), (64, 2), (64, 4), (16, 8),
                                         (15, 1)])
def test_torch_shard_ranges_are_blocks(batch, world):
    ranges = [shard_range(batch, r, world) for r in range(world)]
    assert ranges[0][0] == 0 and ranges[-1][1] == batch
    assert all(hi - lo == batch // world for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_torch_shard_range_refuses_unequal_blocks():
    with pytest.raises(ValueError, match='pad it first'):
        shard_range(15, 0, 2)


@pytest.mark.parametrize('batch,world', [(15, 2), (15, 4), (10, 3), (8, 4)])
def test_torch_pad_batch_is_the_jax_index_formula(batch, world):
    """admm_lstm_tpu/api.py:715-721: arange(B) then arange(pad) % B."""
    x = np.arange(batch * 3, dtype=np.float32).reshape(batch, 3, 1)
    y = np.arange(batch, dtype=np.float32)[:, None]
    px, py = pad_batch(x, y, world)
    pad = (-batch) % world
    idx = np.asarray(jnp.concatenate([jnp.arange(batch),
                                      jnp.arange(pad) % batch]))
    np.testing.assert_array_equal(px, x[idx])
    np.testing.assert_array_equal(py, y[idx])
    tx, ty = pad_batch(torch.from_numpy(x), torch.from_numpy(y), world)
    np.testing.assert_array_equal(tx.numpy(), x[idx])
    assert px.shape[0] % world == 0


def _fake_mesh(rank, world):
    """Rank `rank` of a 1-D mesh of `world`, with no process group."""
    return Mesh(shape=(world,), axis_names=('data',), rank=rank, world=world,
                device=torch.device('cpu'), backend=None, host_group=None,
                consensus=Consensus(world=world, index=rank),
                coords=(rank,))


def test_torch_shard_slabs_are_contiguous_blocks():
    tx, ty, _, _ = synth(batch=16, seq_len=4, input_size=2, output_size=1)
    ps = parameter_set('Synthetic')
    whole = init_admm_state(params_from_dict(_weights()),
                            torch.from_numpy(tx), ps)
    for rank in range(4):
        mesh = _fake_mesh(rank, 4)
        local = shard_state(whole, mesh)
        lo, hi = 4 * rank, 4 * rank + 4
        for k in 'ifgoch':
            slab = getattr(local.gates, k)
            assert slab.is_contiguous() and slab.shape == (5, 5, 4)
            assert torch.equal(slab, getattr(whole.gates, k)[..., lo:hi])
            assert getattr(local.duals, k).is_contiguous()
        assert local.gates.a.is_contiguous()
        assert torch.equal(local.gates.a, whole.gates.a[:, lo:hi])
        x, y = shard_batch(tx, ty, mesh)
        assert x.is_contiguous() and torch.equal(x, torch.from_numpy(
            tx[lo:hi]))
        assert torch.equal(y, torch.from_numpy(ty[lo:hi]))


def test_torch_gather_state_at_one_rank_is_the_state(one_rank_group):
    tx, _, _, _ = synth(batch=8, seq_len=3, input_size=2, output_size=1)
    st = init_admm_state(params_from_dict(_weights()), torch.from_numpy(tx),
                         parameter_set('Synthetic'),
                         ADMMConfig(dtype='bfloat16'))
    back = gather_state(st, make_mesh(device='cpu'))
    assert back.epoch == st.epoch
    for a, b in zip(_leaves(back), _leaves(st)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize('cfg', [
    ADMMConfig(epochs=3, hidden_size=5),
    ADMMConfig.auto(epochs=4, hidden_size=5),
    ADMMConfig(epochs=4, hidden_size=5, adaptive_rho=True,
               with_dual_y=True)], ids=['default', 'auto', 'adaptive_dual_y'])
def test_torch_one_rank_is_bit_equal_to_train(one_rank_group, cfg):
    """A one-rank process group runs every sharded path with the identity
    consensus: the run is api.train's, bit for bit."""
    tx, ty, vx, vy = synth(batch=48, seq_len=5, input_size=2, output_size=1,
                           val_batch=12)
    ps = parameter_set('Synthetic')
    ref = api.train(tx, ty, vx, vy, ps, cfg, log_every=0, device='cpu',
                    params=params_from_dict(_weights()), record_residuals=True)
    got = api.train_sharded(tx, ty, vx, vy, ps, cfg.replace(mesh_shape=(1,)),
                            params=params_from_dict(_weights()), log_every=0,
                            device='cpu', record_residuals=True)
    assert got['train_loss'] == ref['train_loss']
    assert got['val_loss'] == ref['val_loss']
    assert got['residuals'] == ref['residuals']
    assert got['state'].epoch == ref['state'].epoch
    for a, b in zip(_leaves(got['state']), _leaves(ref['state'])):
        assert torch.equal(a, b)
    assert got['mesh']['world'] == 1 and got['mesh']['all_reduces'] == 0


class _Mirror(Consensus):
    """Two ranks that hold the same block: every all-reduce doubles."""

    def __init__(self):
        super().__init__(world=2)

    def all_sum(self, t):
        self.calls += 1
        return t + t


@pytest.mark.parametrize('cfg', [ADMMConfig(hidden_size=5),
                                 ADMMConfig.auto(hidden_size=5)],
                         ids=['default', 'auto'])
def test_torch_a_update_scales_by_the_global_batch(monkeypatch, cfg):
    """On a rank that holds 8 of 16 samples, `a` is scaled by the global
    B = 16 (JAX's state.batch_size under the mesh), not the local 8; and
    an epoch on the block with every sum doubled is the single-process
    epoch on the block twice over."""
    seen = []
    real = cf.a_update

    def spy(train_y, hw, rho_y, lam_y, batch_size, with_dual_y):
        seen.append(batch_size)
        return real(train_y, hw, rho_y, lam_y, batch_size, with_dual_y)

    monkeypatch.setattr(cf, 'a_update', spy)
    tx, ty, _, _ = synth(batch=8, seq_len=5, input_size=2, output_size=1)
    x, y = torch.from_numpy(tx), torch.from_numpy(ty)
    ps = parameter_set('Synthetic')
    params = params_from_dict(_weights())
    rules = rules_for(cfg)
    mirror = dataclasses.replace(rules, consensus=_Mirror())
    local = admm_step(init_admm_state(params, x, ps, cfg), x, y, mirror)
    assert seen == [16] and mirror.consensus.calls >= 5
    x2, y2 = torch.cat([x, x]), torch.cat([y, y])
    whole = admm_step(init_admm_state(params, x2, ps, cfg), x2, y2, rules)
    assert seen == [16, 16]
    for a, b in zip(local.params, whole.params):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    np.testing.assert_allclose(local.gates.h.numpy(),
                               whole.gates.h[..., :8].numpy(), atol=1e-5)
    np.testing.assert_allclose(local.gates.a.numpy(),
                               whole.gates.a[:, :8].numpy(), atol=1e-5)
    for k in 'ifgochy':
        np.testing.assert_allclose(float(getattr(local.rho, k)),
                                   float(getattr(whole.rho, k)), rtol=1e-6)


@pytest.mark.parametrize('rho_g,max_iters', [([0.01, 1., 100., 1e4], 60),
                                              ([0.01, 1., 100., 1e4], 11)])
def test_torch_weight_search_sums_are_global(rho_g, max_iters):
    """The weight stage's search on a block, with every sum doubled (a
    second rank holding the same block), takes the single-process search's
    theta on the block twice over: the gradient, f(W) and each block of
    candidate objectives are all-reduced before they are compared."""
    from admm_lstm_torch.solvers.prox_linear import weight_stage_update_wide
    rng = np.random.default_rng(1)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    seq_len, d, hidden, batch = 5, 3, 4, 20
    m = f32(rng.standard_normal((seq_len, d, batch)) * 3.0)
    w = f32(rng.standard_normal((d, 4 * hidden)) * 0.2)
    proj_self = torch.einsum('tdb,dk->tkb', m, w)
    proj_other = f32(rng.standard_normal((seq_len, 4 * hidden, batch)) * 0.3)
    tanh_cols = torch.arange(4 * hidden) // hidden == 2
    pre = proj_self + proj_other
    act = torch.where(tanh_cols[:, None], torch.tanh(pre), torch.sigmoid(pre))
    target = act + 1e-3 * f32(rng.standard_normal(act.shape))
    rho, beta = f32(rho_g), f32(np.full(4, 8e-7))
    twice = lambda t: torch.cat([t, t], dim=-1)
    local = weight_stage_update_wide(m, proj_self, proj_other, w, target, rho,
                                     beta, tanh_cols, seq_len, max_iters,
                                     consensus=_Mirror())
    whole = weight_stage_update_wide(twice(m), twice(proj_self),
                                     twice(proj_other), w, twice(target), rho,
                                     beta, tanh_cols, seq_len, max_iters)
    assert whole.iters > 8            # more than one block of candidates
    assert torch.equal(local.theta, whole.theta)
    assert local.iters == whole.iters
    np.testing.assert_allclose(local.weights.numpy(), whole.weights.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize('rho_y', [3.0, 300.0])
def test_torch_final_h_search_sums_are_global(rho_y):
    """The final-h search on a block with every sum doubled takes the
    single-process search's theta on the block twice over: f(h) and the
    three sums of each acceptance test are all-reduced."""
    from admm_lstm_torch.solvers.prox_linear import h_final_update
    rng = np.random.default_rng(7)
    batch, hidden, out = 16, 6, 2
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    rows = dict(h_old=f32(rng.standard_normal((batch, hidden)) * 0.5),
                o_new=f32(rng.uniform(0, 1, (batch, hidden))),
                tanh_c_new=f32(np.tanh(rng.standard_normal((batch, hidden)))),
                lam_h=f32(rng.standard_normal((batch, hidden)) * 0.01),
                a_old=f32(rng.standard_normal((batch, out))),
                lam_y=f32(rng.standard_normal((batch, out)) * 0.01))
    fixed = dict(rho_h=f32(0.00045), wy=f32(rng.standard_normal((hidden, out))),
                 rho_y=f32(rho_y), with_dual_y=True, theta0=0.1,
                 theta_max=1e3, max_iters=60)
    local = h_final_update(**rows, **fixed, consensus=_Mirror())
    whole = h_final_update(**{k: torch.cat([v, v]) for k, v in rows.items()},
                           **fixed)
    assert whole.iters > 0
    assert float(local.theta) == float(whole.theta)
    assert local.iters == whole.iters
    np.testing.assert_allclose(local.h.numpy(), whole.h[:batch].numpy(),
                               atol=1e-5)


def test_torch_gram_strategy_sees_the_global_rows(monkeypatch):
    """The exact stage picks its Gram path from the rows of the whole
    batch, as one process (and the JAX package) sees them."""
    from admm_lstm_torch.solvers import normal_eq as ne
    seen = []
    real = ne._gram_strategy
    monkeypatch.setattr(ne, '_gram_strategy',
                        lambda k, d, n: seen.append(n) or real(k, d, n))
    s2, m = torch.rand(3, 8, 5), torch.rand(3, 2, 5)
    ne._gram_bvec(s2, s2, m, world=4)
    ne.gauss_newton_ridge_update_wide(
        m, s2, torch.rand(2, 8), s2, torch.ones(4), torch.ones(4),
        torch.arange(8) // 2 == 2, consensus=_Mirror())
    assert seen == [3 * 5 * 4, 3 * 5 * 2]


def test_torch_resume_of_another_batch_raises(tmp_path):
    tx, ty, vx, vy = synth(batch=16, seq_len=3, input_size=2, output_size=1,
                           val_batch=4)
    ps, cfg = parameter_set('Synthetic'), ADMMConfig(epochs=1, hidden_size=5)
    kw = dict(params=params_from_dict(_weights()), log_every=0, device='cpu')
    api.train(tx, ty, vx, vy, ps, cfg, checkpoint_dir=str(tmp_path),
              checkpoint_every=1, **kw)
    with pytest.raises(ValueError, match='holds a batch of 16'):
        api.train(tx[:8], ty[:8], vx, vy, ps, cfg.replace(epochs=2),
                  resume_from=str(tmp_path), **kw)


@pytest.mark.parametrize('cfg', [ADMMConfig(hidden_size=5),
                                 ADMMConfig.turbo(hidden_size=5,
                                                  adaptive_rho=True)],
                         ids=['default', 'turbo_adaptive'])
def test_torch_sharded_epoch_functions_match_one_process(cfg):
    """The four sharded epoch functions, on a rank that holds a block while
    a mirror rank holds the same block (every all-reduce doubles), match
    one process on the block twice over."""
    from admm_lstm_torch.core.step import run_epochs
    from admm_lstm_torch.parallel import (Mesh, make_sharded_epoch_fn,
                                          make_sharded_multi_epoch_best_fn,
                                          make_sharded_multi_epoch_fn,
                                          make_sharded_step)
    mesh = Mesh(shape=(2,), axis_names=('data',), rank=0, world=2,
                device=torch.device('cpu'), backend=None, host_group=None,
                consensus=_Mirror())
    tx, ty, vx, vy = (torch.from_numpy(a) for a in synth(
        batch=12, seq_len=4, input_size=2, output_size=1, val_batch=6))
    ps, params = parameter_set('Synthetic'), params_from_dict(_weights())
    x2, y2 = torch.cat([tx, tx]), torch.cat([ty, ty])
    local = lambda: init_admm_state(params, tx, ps, cfg)
    whole = init_admm_state(params, x2, ps, cfg)
    rules = rules_for(cfg)
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)

    got = make_sharded_step(cfg, mesh)(local(), tx, ty)
    want = admm_step(whole, x2, y2, rules)
    for a, b in zip(got.params, want.params):
        close(a, b)

    got, metrics = make_sharded_epoch_fn(cfg, mesh)(local(), tx, ty, vx, vy)
    x_im, y_im, xall_im, vy_im = api.batch_minor(x2, y2, vx, vy)
    want, want_m = run_epochs(whole, 1, x_im, y_im, xall_im, vy_im, rules)
    close(metrics['train_loss'], want_m['train_loss'][0])
    close(metrics['val_loss'], want_m['val_loss'][0])

    got, traj = make_sharded_multi_epoch_fn(cfg, mesh, 3, True)(
        local(), tx, ty, vx, vy)
    want, want_t = run_epochs(whole, 3, x_im, y_im, xall_im, vy_im, rules,
                              True)
    assert list(traj) == list(want_t)
    for k in traj:
        close(traj[k], want_t[k])

    best = {'val': torch.tensor(1e9), 'params': params.clone()}
    got, bv, bp, traj = make_sharded_multi_epoch_best_fn(cfg, mesh, 3)(
        local(), torch.tensor(1e9), params.clone(), tx, ty, vx, vy)
    want, want_t = run_epochs(whole, 3, x_im, y_im, xall_im, vy_im, rules,
                              best=best)
    close(bv, best['val'])
    for a, b in zip(bp, best['params']):
        close(a, b)
    assert got.epoch == 3


def test_torch_train_sharded_without_card_or_mesh_raises():
    tx, ty, vx, vy = synth(batch=8, seq_len=3, input_size=2, output_size=1,
                           val_batch=4)
    ps = parameter_set('Synthetic')
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDeviceError):
            api.train_sharded(tx, ty, vx, vy, ps,
                              ADMMConfig(epochs=1, mesh_shape=(2,)))
    with pytest.raises(ValueError, match='mesh_shape'):
        api.train_sharded(tx, ty, vx, vy, ps, ADMMConfig(epochs=1),
                          device='cpu')
    with pytest.raises(ValueError, match='mesh_shape'):
        api.train_sharded(tx, ty, vx, vy, ps,
                          ADMMConfig(epochs=1, mesh_shape=(2, 2, 1)),
                          device='cpu')


_LAST = re.compile(r'Epoch 2 has done .* Training: ([0-9]+\.[0-9]+) \| '
                   r'Validation: ([0-9]+\.[0-9]+)')


def _cli(args, tmp_path):
    env = dict(os.environ, ADMM_TORCH_NO_FILELOG='1', PYTHONPATH=ROOT,
               OMP_NUM_THREADS='1')
    return subprocess.run([sys.executable, '-m', 'admm_lstm_torch.cli',
                           *args], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)


def test_torch_cli_mesh_matches_one_process(tmp_path):
    base = ['--cpu', '-y', '-d', 'Synthetic', '-e', '2', '--no-plot']
    losses, said = [], []
    for extra in (['--mesh', '2'], []):
        proc = _cli(base + extra, tmp_path)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        found = _LAST.findall(proc.stdout)
        assert len(found) == 1, proc.stdout
        losses.append([float(v) for v in found[0]])
        said.append('--mesh 2: backend gloo, 2 ranks on the CPU' in
                    proc.stdout)
    assert said == [True, False]
    np.testing.assert_allclose(losses[0], losses[1], atol=1e-5)


@pytest.mark.parametrize('extra', [['--preset', 'best'], ['--layers', '2'],
                                   ['--variant', 'admm_l']])
def test_torch_cli_mesh_refuses_single_device_paths(extra):
    from admm_lstm_torch.cli import main
    assert main(['--cpu', '-y', '-e', '1', '--no-plot', '-d', 'Synthetic',
                 '--mesh', '2', *extra]) == 1
