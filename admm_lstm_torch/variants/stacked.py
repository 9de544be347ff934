"""Stacked N-layer LSTM trained by ADMM.

Counterpart of `admm_lstm_tpu/variants/stacked.py`, whose docstring
derives the formulation.  Layer k maps H_{k-1} -> H_k and a linear head
reads the top layer's final h.  Every layer above the first carries
pre-activation auxiliaries

    z_k,t   = wx_k h_{k-1,t} + wh_k h_{k,t-1}     (linear, dual lam_z)
    gate_k,t = act(z_k,t)                          (elementwise)

so every inter-layer solve is quadratic:

  * layer 0 keeps the single-layer treatment; its weights take the
    LM-anchored exact Gauss-Newton solve (solvers/normal_eq, which runs
    the `chol_solve` kernel on CUDA tensors) whatever
    `exact_weight_solve` says;
  * an upper layer's weights take an exact, proximally damped ridge
    solve against its z targets;
  * h of a layer below the top is a ridge solve against the z above it,
    whose matrix is fixed for the epoch and inverted once;
  * z takes a majorized prox-linear step against the gate fit;
  * the top layer's final h keeps the output prox, `a` and the y-dual.

Epoch order: wy -> layer-0 weights -> upper-layer weights -> one sweep
over t (bottom-up per timestep), duals inside the sweep.  The h duals of
the layers below the top pass through unchanged; the top layer's is
written only at t = T.

The JAX package runs the sweep as a `lax.scan` with no Pallas kernel.
Here, on CUDA tensors at the 'highest' matmul precision, one CUDA kernel
runs every timestep and layer of it (kernels/stacked_sweep.py, one
launch an epoch, where the stack fits its shared-memory plan); otherwise,
and always on the CPU, `stacked_sweep_plain`, its plain version, runs
it as a Python loop over the timesteps and layers that writes each
step's results into new (T+1, ...) slabs.  Slabs are time-major,
batch-minor as in the core state: gates and duals (T+1, H, B), z and
z-duals (T+1, 4, H, B), `a` and lam_y (O, B).  The coupled h solves'
per-epoch inverse is a Cholesky inverse, L^-T L^-1, with L^-1 from the
`chol_inverse` kernel (its plain version on the CPU, under
use_pallas_chol=False and past its width); the upper-layer solves use
`solve_ex`, which checks no errors on the host, but whose LU
factorization waits for the device (three times an epoch at S 27 on an
H100, PERF.md); the final-h search's reads are the epoch's other host
syncs (solvers/prox_linear.h_final_update).

The candidate axis (core/state.py) runs S independent stacks in one
epoch, the JAX package's `vmap` of its stacked epoch written out, as
`tune.search_rho_stacked` trains its candidates: every leaf of the state
carries a leading S (`broadcast_stacked_state`, `take`, `unstack`), the
time axis of every slab moves to axis 1, the products are `...`-einsums
and broadcasting matmuls, each rho is viewed as (S, 1, ...), and rho_z is
(S,) or one 0-d penalty shared by the candidates.  The data is shared by
the candidates.  Layer 0's exact stage solves the S x 4H systems of each
side in one `chol_solve` call; the final-h search searches per candidate
with one host read per block for all of them.  A state without the axis
takes the same code.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from admm_lstm_torch.core.loop import batch_minor, run_chunked
from admm_lstm_torch.core.state import (DualSlabs, GateSlabs, Penalties,
                                        Ridges, penalties_from, ridges_from)
from admm_lstm_torch.core.step import (StepRules, _from_wide, _per_candidate,
                                       _timestep_primal_duals, _to_wide,
                                       gate_is_tanh, rules_for,
                                       wide_targets)
from admm_lstm_torch.kernels.cholesky import (MAX_DIM, chol_inverse,
                                              chol_inverse_plain)
from admm_lstm_torch.kernels.stacked_sweep import (stacked_sweep,
                                                   stacked_sweep_plan,
                                                   use_stacked_kernel)
from admm_lstm_torch.models.lstm import (LSTMParams, _xavier_normal,
                                         init_lstm_params, params_from_dict)
from admm_lstm_torch.solvers import closed_form as cf
from admm_lstm_torch.solvers.normal_eq import gauss_newton_ridge_update_wide
from admm_lstm_torch.solvers.prox_linear import h_final_update
from admm_lstm_torch.utils.config import ADMMConfig, ParameterSet
from admm_lstm_torch.utils.device import (as_tensor, matmul_precision,
                                          resolve_device)
from admm_lstm_torch.utils.observe import span


class StackedParams(NamedTuple):
    """N LSTM layers and the head on the top layer's final h.  Layer k:
    wx (4, H_{k-1}, H_k), wh (4, H_k, H_k) and an unused wy (H_k, O)
    that the `.npz` format keeps; the head wy is (H_top, O) (each with a
    leading S under the candidate axis)."""

    layers: Tuple[LSTMParams, ...]
    wy: torch.Tensor

    @property
    def layer1(self) -> LSTMParams:
        return self.layers[0]

    @property
    def layer2(self) -> LSTMParams:
        return self.layers[-1]

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return tuple(w for lp in self.layers for w in lp) + (self.wy,)

    def rebuild(self, tensors) -> 'StackedParams':
        """The same structure over `tensors`, in `tensors()` order."""
        tensors = list(tensors)
        layers = tuple(LSTMParams(*tensors[3 * k:3 * k + 3])
                       for k in range(len(self.layers)))
        return StackedParams(layers=layers, wy=tensors[-1])

    def to(self, device) -> 'StackedParams':
        return self.rebuild(w.to(device) for w in self.tensors())

    def clone(self) -> 'StackedParams':
        return self.rebuild(w.clone() for w in self.tensors())


class StackedState(NamedTuple):
    """Under the candidate axis every leaf has a leading S (slabs
    (S, T+1, H, B), z slabs (S, T+1, 4, H, B), each rho (S,), the ridges
    (S, 4) and (S,)) but rho_z, which is (S,) or one 0-d penalty shared by
    the candidates."""

    params: StackedParams
    gates: Tuple[GateSlabs, ...]   # per layer; only the top's `a` is live
    duals: Tuple[DualSlabs, ...]   # per layer; only the top's `y` is live
    zs: Tuple[torch.Tensor, ...]   # n-1 slabs: z of layer j+1, (T+1, 4, H, B)
    zduals: Tuple[torch.Tensor, ...]
    rho: Penalties
    rho_z: torch.Tensor            # 0-d penalty of the z constraints
    beta: Ridges
    epoch: int

    @property
    def candidates(self) -> Optional[int]:
        """S, the length of the leading candidate axis, or None for one
        instance."""
        slab = self.gates[0].i
        return slab.shape[0] if slab.dim() == 4 else None

    @property
    def gates1(self) -> GateSlabs:
        return self.gates[0]

    @property
    def gates2(self) -> GateSlabs:
        return self.gates[-1]

    @property
    def duals1(self) -> DualSlabs:
        return self.duals[0]

    @property
    def duals2(self) -> DualSlabs:
        return self.duals[-1]


def init_stacked(generator: torch.Generator, input_size: int,
                 hiddens: Sequence[int], output_size: int,
                 device='cpu') -> StackedParams:
    """Xavier-normal init of an N-layer stack (hiddens: per-layer widths),
    layer by layer as `init_lstm_params` draws, then the head."""
    if len(hiddens) < 1:
        raise ValueError('need at least one layer')
    layers = []
    prev = input_size
    for hdim in hiddens:
        layers.append(init_lstm_params(generator, prev, int(hdim),
                                       output_size, device=device))
        prev = int(hdim)
    wy = _xavier_normal(generator, (prev, output_size), torch.float32, device)
    return StackedParams(layers=tuple(layers), wy=wy)


def init_stacked_params(generator: torch.Generator, input_size: int, h1: int,
                        h2: int, output_size: int,
                        device='cpu') -> StackedParams:
    """The 2-layer stack (h1, h2)."""
    return init_stacked(generator, input_size, (h1, h2), output_size,
                        device=device)


def stacked_params_from_dict(weights: dict, device='cpu') -> StackedParams:
    """StackedParams from the `.npz` naming: l{k}_x2i ... l{k}_h2o,
    l{k}_wy per layer, and the head wy (numpy arrays, e.g. a JAX
    package's StackedParams saved with its save_model)."""
    layers = []
    k = 0
    while f'l{k}_x2i' in weights:
        prefix = f'l{k}_'
        layers.append(params_from_dict(
            {name[len(prefix):]: w for name, w in weights.items()
             if name.startswith(prefix)}, device=device))
        k += 1
    if not layers:
        raise KeyError('l0_x2i: not a stacked model')
    wy = torch.as_tensor(np.asarray(weights['wy'], np.float32), device=device)
    return StackedParams(layers=tuple(layers), wy=wy)


def _view(r: torch.Tensor, dims: int) -> torch.Tensor:
    """A per-candidate (S,) tensor viewed as (S, 1, ..., 1) to broadcast
    over `dims` trailing axes of a candidate; a 0-d one as it is."""
    return r.reshape(r.shape + (1,) * dims) if r.dim() else r


def _map_state(state: StackedState, fn, rho_z_fn) -> StackedState:
    """`fn` applied to every tensor leaf but rho_z, which takes
    `rho_z_fn`; `epoch` kept."""
    return StackedState(
        params=state.params.rebuild(map(fn, state.params.tensors())),
        gates=tuple(GateSlabs(*map(fn, g)) for g in state.gates),
        duals=tuple(DualSlabs(*map(fn, d)) for d in state.duals),
        zs=tuple(map(fn, state.zs)), zduals=tuple(map(fn, state.zduals)),
        rho=Penalties(*map(fn, state.rho)), rho_z=rho_z_fn(state.rho_z),
        beta=Ridges(*map(fn, state.beta)), epoch=state.epoch)


def broadcast_stacked_state(state: StackedState, count: int,
                            rho: Optional[Penalties] = None,
                            rho_z=None) -> StackedState:
    """`count` copies of a stacked state without the candidate axis on a
    new leading axis (core/state.broadcast_state's counterpart), each leaf
    a contiguous tensor of its own.  `rho`, if given, holds the (count,)
    penalties of the candidates and `rho_z` their (count,) z penalties;
    without `rho_z` the state's 0-d one stays shared."""
    out = _map_state(state,
                     lambda t: t.expand((count,) + t.shape).contiguous(),
                     torch.clone)
    if rho is not None:
        out = out._replace(rho=rho)
    if rho_z is not None:
        out = out._replace(rho_z=torch.as_tensor(
            np.asarray(rho_z, np.float32).reshape(count)).to(
                state.rho_z.device))
    return out


def take(state: StackedState, index) -> StackedState:
    """Candidate `index` (an int: a state without the axis) or candidates
    `index` (a slice: a state with it) of a stacked state with the axis."""
    return _map_state(state, lambda t: t[index],
                      lambda r: r[index] if r.dim() else r)


def unstack(state: StackedState) -> List[StackedState]:
    """The S stacked states of a state with the candidate axis."""
    return [take(state, s) for s in range(state.candidates)]


def _rows(w: torch.Tensor) -> torch.Tensor:
    """(..., 4, D, H) -> (..., 4H, D): `_project(_rows(w), v)` is
    einsum('...db,...gdh->...ghb', v, w)."""
    return w.mT.reshape(w.shape[:-3] + (-1, w.shape[-2])).contiguous()


def _project(rows: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 4H, D) rows times a (..., D, B) block -> (..., 4, H, B)."""
    out = rows @ v
    return out.view(out.shape[:-2] + (4, -1, out.shape[-1]))


def _scan_stack(params: StackedParams, x_im: torch.Tensor, collect: bool):
    """The N-layer forward on (T, I, B) inputs.  Returns the final (h, c)
    of every layer, each (H_k, B), and with `collect` each layer's gate
    history as (T+1, H, B) slabs (i, f, g, o, c, h; zero row 0) and each
    upper layer's pre-activations as a (T+1, 4, H, B) slab; with
    per-candidate weights every result has their leading S."""
    seq_len, _, batch = x_im.shape[-3:]
    n = len(params.layers)
    lead = torch.broadcast_shapes(x_im.shape[:-3], params.wy.shape[:-2])
    rec = [_rows(lp.wh) for lp in params.layers]
    inp = [None] + [_rows(lp.wx) for lp in params.layers[1:]]
    xproj = torch.einsum('...tdb,...gdh->...tghb', x_im,
                         params.layers[0].wx)
    h = [x_im.new_zeros(lead + (lp.hidden_size, batch))
         for lp in params.layers]
    c = list(h)
    hist, pres = None, None
    if collect:
        hist = [[x_im.new_zeros(lead + (seq_len + 1, lp.hidden_size, batch))
                 for _ in range(6)] for lp in params.layers]
        pres = [x_im.new_zeros(lead + (seq_len + 1, 4, lp.hidden_size,
                                       batch))
                for lp in params.layers[1:]]
    for t in range(seq_len):
        inp_proj = xproj[..., t, :, :, :]
        for k in range(n):
            pre = inp_proj + _project(rec[k], h[k])
            if collect and k > 0:
                pres[k - 1][..., t + 1, :, :, :] = pre
            sig = torch.sigmoid(pre)
            i, f, o = sig[..., 0, :, :], sig[..., 1, :, :], sig[..., 3, :, :]
            g = torch.tanh(pre[..., 2, :, :])
            c[k] = f * c[k] + i * g
            h[k] = o * torch.tanh(c[k])
            if collect:
                for slab, v in zip(hist[k], (i, f, g, o, c[k], h[k])):
                    slab[..., t + 1, :, :] = v
            if k + 1 < n:
                inp_proj = _project(inp[k + 1], h[k])
    return (h, c), (hist, pres)


def stacked_forward_im(params: StackedParams,
                       x_im: torch.Tensor) -> torch.Tensor:
    """Inference on batch-minor (T, I, B) inputs -> (O, B) predictions
    ((S, O, B) with per-candidate weights)."""
    (h, _), _ = _scan_stack(params, x_im, collect=False)
    return torch.einsum('...hb,...ho->...ob', h[-1], params.wy)


def stacked_forward(params: StackedParams, x: torch.Tensor) -> torch.Tensor:
    """Inference: (B, T, I) -> (B, O)."""
    return stacked_forward_im(params, x.movedim(-3, -1)).transpose(-2, -1)


def stacked_mse_loss(params: StackedParams, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    return torch.mean((stacked_forward(params, x) - y) ** 2)


def stacked_train_val_mse_im(params: StackedParams, xall_im: torch.Tensor,
                             y_im: torch.Tensor, vy_im: torch.Tensor):
    """Both epoch metrics from one forward over the train and validation
    inputs concatenated along the batch, (T, I, B + Bv); 0-d tensors on
    the device ((S,) each with per-candidate weights, each candidate's
    mean over its own predictions)."""
    nb = y_im.shape[-1]
    pred = stacked_forward_im(params, xall_im)
    return (torch.mean((pred[..., :nb] - y_im) ** 2, dim=(-2, -1)),
            torch.mean((pred[..., nb:] - vy_im) ** 2, dim=(-2, -1)))


def init_stacked_state(params: StackedParams, x: torch.Tensor,
                       parameter_set: ParameterSet,
                       config: ADMMConfig = ADMMConfig()) -> StackedState:
    """Seed every layer's gate and z slabs with one forward unroll; duals
    start at zero.  The state lives on x's device; rho_z is the
    parameter set's 'z' penalty (1.0 without one)."""
    device, dtype = x.device, torch.float32
    batch, seq_len, input_size = x.shape
    if input_size != params.layers[0].input_size:
        raise ValueError(f'x feature dim {input_size} != model input size '
                         f'{params.layers[0].input_size}')
    params = params.to(device)
    x_im = x.permute(1, 2, 0).to(dtype).contiguous()
    (h, _), (hist, pres) = _scan_stack(params, x_im, collect=True)
    a = torch.einsum('hb,ho->ob', h[-1], params.wy)
    out = params.wy.shape[1]
    n = len(params.layers)
    gates, duals, zs, zduals = [], [], [], []
    for k, lp in enumerate(params.layers):
        zero = lambda: torch.zeros((seq_len + 1, lp.hidden_size, batch),
                                   dtype=dtype, device=device)
        gates.append(GateSlabs(*hist[k], a=a if k == n - 1 else
                               torch.zeros((out, batch), dtype=dtype,
                                           device=device)))
        duals.append(DualSlabs(*(zero() for _ in range(6)),
                               y=torch.zeros((out, batch), dtype=dtype,
                                             device=device)))
        if k > 0:
            zs.append(pres[k - 1])
            zduals.append(torch.zeros_like(pres[k - 1]))
    return StackedState(
        params=params, gates=tuple(gates), duals=tuple(duals), zs=tuple(zs),
        zduals=tuple(zduals), rho=penalties_from(parameter_set, dtype, device),
        rho_z=torch.tensor(parameter_set.rho.get('z', 1.0), dtype=dtype,
                           device=device),
        beta=ridges_from(parameter_set, dtype, device), epoch=0)


def _project_wide(m_rows: torch.Tensor, w_w: torch.Tensor,
                  onto: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., T, D, B) rows times (..., D, 4H) wide weights: the
    (..., T, 4H, B) projection with b contiguous, the layout the exact
    stage's Gram kernel reads, so a pre-activation needs no copy.  With
    `onto` (contiguous, of the result's shape) one batched GEMM adds the
    projection to it in place and returns it."""
    w_t = w_w.mT.unsqueeze(-3)                          # (..., 1, 4H, D)
    if onto is None:
        return torch.matmul(w_t, m_rows)
    lead, out = onto.shape[:-2], onto.shape[-2:]
    flat = lambda t: t.expand(lead + t.shape[-2:]).reshape((-1,)
                                                           + t.shape[-2:])
    onto.view((-1,) + out).baddbmm_(flat(w_t), flat(m_rows))
    return onto


def _layer0_weight_phase(x_im, gates: GateSlabs, duals: DualSlabs,
                         params_layer: LSTMParams, rho: Penalties,
                         beta: Ridges, rules: StepRules) -> LSTMParams:
    """Layer 0's weights by the LM-anchored exact Gauss-Newton ridge solve
    against its ground-truth inputs (JAX stacked.py:290-339), x side then
    h side, in the gate-folded batch-minor layout: x_im (T, D, B), slabs
    (T+1, H, B).  With the candidate axis the slabs, weights, rho and beta
    carry a leading S, x_im is shared, and each side's S x 4H systems go
    to one batched solve.  `exact_weight_solve=False` does not apply
    here: the prox-linear search takes catastrophic steps inside a stack
    on long horizons (the JAX module docstring)."""
    hidden = params_layer.hidden_size
    rho_g = rho.stacked_ifgo()
    target_w = wide_targets(gates, duals, rho)
    tanh_cols = gate_is_tanh(4 * hidden, hidden, x_im.device)
    h_hist = gates.h[..., :-1, :, :]                  # (T, H, B)

    wx_w, wh_w = _to_wide(params_layer.wx), _to_wide(params_layer.wh)
    hproj = _project_wide(h_hist, wh_w)

    def solve(m_inputs, pre, w_w, beta_g):
        return gauss_newton_ridge_update_wide(
            m_inputs, pre, w_w, target_w, rho_g, beta_g, tanh_cols,
            rules.matmul_precision, use_pallas_chol=rules.use_pallas_chol)

    with span('weights.x'):
        wx_new_w = solve(x_im, _project_wide(x_im, wx_w, onto=hproj.clone()),
                         wx_w, beta.x)
    with span('weights.h'):
        wh_new_w = solve(h_hist, _project_wide(x_im, wx_new_w, onto=hproj),
                         wh_w, beta.h)
    return params_layer._replace(wx=_from_wide(wx_new_w, hidden),
                                 wh=_from_wide(wh_new_w, hidden))


def _upper_weight_solve(h_below_hist, h_own_hist, z_slab, zdual_slab,
                        params_layer: LSTMParams, rho_z,
                        beta: Ridges) -> LSTMParams:
    """Proximally damped joint ridge solve for an upper layer's (wx, wh)
    (JAX stacked.py:342-377): per gate, with X = [h_{k-1,t}; h_{k,t-1}]
    shared by the four gates,

      min_W  rho_z/2 sum_{t,b} ||X W - (z + lam_z/rho_z)||^2
             + beta/2 ||W||^2 + theta/2 ||W - W_old||^2,

    theta = the Gram's mean diagonal.  h histories (T, H, B), z slabs
    (T+1, 4, H, B); with the candidate axis each with a leading S, and
    rho_z (S,) or 0-d.

    It runs in float64 and returns float32 weights.  Its Gram and
    right-hand side are sums over the T*B rows, and in float32 their
    rounding depends on how the card's GEMM splits that sum (one GEMM
    alone, a batched GEMM for the candidate axis): on an H100, at
    GoogleStock's 38,016 rows, the (8, 8) search's candidates ended 30
    epochs up to 5.8e-5 away from their runs alone, and 9.1e-7 in float64
    (chip_smoke.py's stacked phase, PERF.md)."""
    f64 = lambda t: t.to(torch.float64)
    h_below_hist, h_own_hist, z_slab, zdual_slab, rho_z = map(
        f64, (h_below_hist, h_own_hist, z_slab, zdual_slab, rho_z))
    beta = beta._replace(x=f64(beta.x), h=f64(beta.h))
    seq_len, d_below, batch = h_below_hist.shape[-3:]
    lead = h_below_hist.shape[:-3]
    d_own = h_own_hist.shape[-2]
    hidden = params_layer.hidden_size
    rz2 = _view(rho_z, 2)
    x_rows = torch.cat([h_below_hist, h_own_hist], dim=-2)  # (T, D, B)
    dim = d_below + d_own
    x_flat = x_rows.transpose(-3, -2).reshape(lead + (dim, seq_len * batch))
    target = (z_slab[..., 1:, :, :, :]
              + zdual_slab[..., 1:, :, :, :] / _view(rho_z, 4))
    t_flat = target.movedim(-4, -2).reshape(lead + (4 * hidden,
                                                    seq_len * batch))
    gram = rz2 * (x_flat @ x_flat.mT)                        # (D, D)
    rhs = (rz2 * (t_flat @ x_flat.mT)).view(lead + (4, hidden, dim)).mT
    reg = torch.cat([beta.x[..., None].expand(beta.x.shape + (d_below,)),
                     beta.h[..., None].expand(beta.h.shape + (d_own,))],
                    dim=-1)                                  # (4, D)
    # Each candidate's trace (torch.trace takes no batch).
    theta = _view(torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1) / dim, 3)
    w_old = f64(torch.cat([params_layer.wx, params_layer.wh], dim=-2))
    eye = torch.eye(dim, dtype=gram.dtype, device=gram.device)
    mats = gram[..., None, :, :] + torch.diag_embed(reg) + theta * eye
    sol = torch.linalg.solve_ex(mats, rhs + theta * w_old).result.float()
    return params_layer._replace(wx=sol[..., :d_below, :].contiguous(),
                                 wh=sol[..., d_below:, :].contiguous())


def _z_prox_update(z_old, gate_target, v, rho_g4, rho_z, is_tanh,
                   resid_max):
    """Majorized prox-linear z step (JAX stacked.py:380-401): per element
    min_z rho_g/2 (u - act(z))^2 + rho_z/2 (z - v)^2, linearized at z_old
    with the global curvature bound theta >= rho_g (act'^2 + |resid|
    |act''|).  resid_max: max |act(z_old) - u| over the (4, H, B) block,
    from the previous epoch's slabs (with the candidate axis each
    candidate's own, and rho_g4 and rho_z too, viewed to broadcast over
    its block)."""
    sig = torch.sigmoid(z_old)
    tanh = torch.tanh(z_old)
    act = torch.where(is_tanh, tanh, sig)
    d_act = torch.where(is_tanh, 1.0 - tanh ** 2, sig * (1.0 - sig))
    resid = act - gate_target
    grad = rho_g4 * resid * d_act
    theta = rho_g4 * torch.where(is_tanh, 1.0 + 0.8 * resid_max,
                                 0.0625 + 0.1 * resid_max)
    return (theta * z_old - grad + rho_z * v) / (theta + rho_z)


def stacked_admm_step(state: StackedState, train_x: torch.Tensor,
                      train_y: torch.Tensor, rules: StepRules
                      ) -> StackedState:
    """One N-layer ADMM epoch on (B, T, I) inputs and (B, O) targets."""
    x_im = train_x.permute(1, 2, 0).float().contiguous()
    y_im = train_y.T.float().contiguous()
    return stacked_admm_step_im(state, x_im, y_im, rules)


def stacked_admm_step_im(state: StackedState, x_im: torch.Tensor,
                         y_im: torch.Tensor, rules: StepRules
                         ) -> StackedState:
    """One N-layer ADMM epoch on batch-minor (T, I, B) inputs and (O, B)
    targets (JAX stacked.py:412-689).  A state with the candidate axis
    takes them shared by its candidates; the time index of every slab is
    then its axis 1, and every max, trace and sum is each candidate's
    own.  Under a profiler the epoch is an `epoch` span around `wy`,
    layer 0's `weights.x` and `weights.h`, each upper layer's
    `weights.upper`, `sweep.interior` (the inverses of the coupled h
    solves and the sweep over t and the layers: the kernel's launch inside
    a `sweep.kernel` span, or the loop) and `sweep.final` (the top layer's
    final h, a and duals)."""
    with span('epoch'):
        return _stacked_epoch(state, x_im, y_im, rules)


def _stacked_epoch(state: StackedState, x_im: torch.Tensor,
                   y_im: torch.Tensor, rules: StepRules) -> StackedState:
    seq_len, _, batch = x_im.shape
    rho, rho_z = state.rho, state.rho_z
    rho2 = _per_candidate(rho, 2)                     # over (H, B)
    rz2 = _view(rho_z, 2)                             # over (H, B)
    n = len(state.params.layers)
    top = n - 1
    hiddens = [lp.hidden_size for lp in state.params.layers]
    g_top, d_top = state.gates[top], state.duals[top]
    decay = rules.stacked_dual_decay
    damp = (lambda v: v) if decay == 1.0 else (lambda v: decay * v)

    # 1. The readout on the top layer's final h.
    with span('wy'):
        wy_new = cf.wy_update(state.params.wy, g_top.h[..., -1, :, :],
                              g_top.a, rho2.y, _view(state.beta.wy, 2),
                              d_top.y, rules.with_dual_y)

    # 2. Weights from the previous epoch's slabs: layer 0 exact GN ridge
    # against x; each upper layer an exact ridge against its z targets,
    # with the SAME-t rows h[1:] below and its own shifted rows h[:-1].
    layers_new = [_layer0_weight_phase(x_im, state.gates[0], state.duals[0],
                                       state.params.layers[0], rho,
                                       state.beta, rules)]
    for k in range(1, n):
        with span('weights.upper'):
            layers_new.append(_upper_weight_solve(
                state.gates[k - 1].h[..., 1:, :, :],
                state.gates[k].h[..., :-1, :, :], state.zs[k - 1],
                state.zduals[k - 1], state.params.layers[k], rho_z,
                state.beta))
    params_new = StackedParams(layers=tuple(layers_new), wy=wy_new)

    # 3. The sweep, t = 1..T, into new slabs: the CUDA kernel where the
    # device, the precision and the stack's shapes allow it, else the loop.
    with span('sweep.interior'):
        use_kernel = use_stacked_kernel(
            x_im.device.type, rules.matmul_precision,
            stacked_sweep_plan(hiddens, x_im.shape[1]))
        m_invs = _sweep_inverses(layers_new, rho2.h, rz2,
                                 rules.use_pallas_chol)
        args = (x_im, state.gates, state.duals, state.zs, state.zduals,
                layers_new, m_invs, rho, rho_z, decay)
        if use_kernel:
            with span('sweep.kernel'):
                new_gates, new_duals, new_zs, new_zduals = stacked_sweep(
                    *args)
        else:
            new_gates, new_duals, new_zs, new_zduals = stacked_sweep_plain(
                *args)

    # The top layer's final h: the output prox, then a and the h-dual.
    with span('sweep.final'):
        o_T = new_gates[top][3][..., seq_len, :, :]
        c_T = new_gates[top][4][..., seq_len, :, :]
        tanh_c_T = torch.tanh(c_T)
        to_out = lambda v: torch.einsum('...hb,...ho->...ob', v, wy_new)
        from_out = lambda r: torch.einsum('...ob,...ho->...hb', r, wy_new)
        h_T = h_final_update(
            g_top.h[..., seq_len, :, :], o_T, tanh_c_T,
            d_top.h[..., seq_len, :, :], rho2.h, wy_new, g_top.a, rho2.y,
            d_top.y, with_dual_y=rules.with_dual_y, theta0=rules.h_theta0,
            theta_max=rules.h_theta_max, max_iters=rules.max_backtrack,
            grad_uses_rho_h=rules.h_grad_uses_rho_h,
            probe_is_grad_over_theta=rules.h_probe_grad_over_theta,
            to_out=to_out, from_out=from_out).h
        new_gates[top][5][..., seq_len, :, :] = h_T
        hw_T = to_out(h_T)
        a_new = cf.a_update(y_im, hw_T, rho2.y, d_top.y, batch,
                            rules.with_dual_y)
        lam_h_top = d_top.h.clone()
        lam_h_top[..., seq_len, :, :] = damp(cf.dual_h_update(
            d_top.h[..., seq_len, :, :], rho2.h, h_T, o_T, tanh_c_T))
        lam_y = d_top.y
        if rules.with_dual_y:
            lam_y = cf.dual_y_update(d_top.y, rho2.y, a_new, hw_T)

    gates_new, duals_new = [], []
    for k in range(n):
        if k == top:
            gates_new.append(GateSlabs(*new_gates[k], a=a_new))
            duals_new.append(DualSlabs(*new_duals[k], h=lam_h_top, y=lam_y))
        else:
            # The h duals below the top pass through unchanged.
            gates_new.append(GateSlabs(*new_gates[k], a=state.gates[k].a))
            duals_new.append(DualSlabs(*new_duals[k], h=state.duals[k].h,
                                       y=state.duals[k].y))
    return StackedState(params=params_new, gates=tuple(gates_new),
                        duals=tuple(duals_new), zs=tuple(new_zs),
                        zduals=tuple(new_zduals), rho=state.rho,
                        rho_z=state.rho_z, beta=state.beta,
                        epoch=state.epoch + 1)


def _sweep_inverses(layers: Sequence[LSTMParams], rho_h, rz2,
                    use_pallas_chol) -> List[torch.Tensor]:
    """The h solve of layer k < top has the fixed matrix M_k = rho_h I +
    rho_z sum_g wx_g wx_g^T of the layer above: each M_k^-1, ([S,] H, H),
    as L^-T L^-1 of the SPD M_k = L L^T, every candidate's L^-1 in one
    `chol_inverse` call.  rho_h and rz2 are viewed to broadcast over a
    candidate's (H, H).  True and 'auto' take the kernel (for CUDA
    tensors; the wrapper runs the plain version on CPU tensors), as
    `solvers/normal_eq._spd_solve` does; False, and a layer wider than
    the kernel's MAX_DIM, run the plain version."""
    out = []
    for k in range(len(layers) - 1):
        inp = _rows(layers[k + 1].wx)
        dim = layers[k].hidden_size
        eye = torch.eye(dim, dtype=inp.dtype, device=inp.device)
        m = rho_h * eye + rz2 * (inp.mT @ inp)
        invert = chol_inverse if use_pallas_chol in (True, 'auto') and \
            dim <= MAX_DIM else chol_inverse_plain
        low_inv = invert(m.reshape((-1, dim, dim)).contiguous()).view(
            m.shape)
        out.append(low_inv.mT @ low_inv)
    return out


def stacked_sweep_plain(x_im, gates, duals, zs, zduals,
                        layers: Sequence[LSTMParams],
                        m_invs: Sequence[torch.Tensor], rho: Penalties,
                        rho_z: torch.Tensor, decay: float):
    """The sweep t = 1..T, bottom-up per timestep, as a Python loop over
    the timesteps and layers that writes each step's results into new
    (T+1, ...) slabs (row 0 stays zero): the plain version of
    `kernels/stacked_sweep.stacked_sweep`, with the same arguments and
    return.  x_im (T, I, B); per layer the previous epoch's GateSlabs and
    DualSlabs, the upper layers' z and z-dual slabs; the epoch's new
    weights per layer; `_sweep_inverses`; the penalties; the dual decay.
    Returns (gates, duals, zs, zduals): per layer the 6 gate slabs i..h
    and the 5 dual slabs i..c, and the upper layers' z and z-dual slabs.
    The top layer's h at T stays zero (sweep.final writes it)."""
    seq_len, _, batch = x_im.shape
    lead = gates[0].a.shape[:-2]                      # (S,) or ()
    rho2 = _per_candidate(rho, 2)                     # over (H, B)
    rz2, rz3 = _view(rho_z, 2), _view(rho_z, 3)       # (H, B), (4, H, B)
    n = len(layers)
    top = n - 1
    hiddens = [lp.hidden_size for lp in layers]
    rho_g4 = rho.stacked_ifgo()[..., None, None]      # ([S,] 4, 1, 1)
    is_tanh4 = gate_is_tanh(4, 1, x_im.device)[:, None, None]
    damp = (lambda v: v) if decay == 1.0 else (lambda v: decay * v)

    def row4(s, t):
        """Row t of a ([S,] T+1, 4, H, B) slab."""
        return s[..., t, :, :, :]

    def coupled_h_solve(k, t, o_n, c_n, lam_h, h_above_prev):
        """h_{k,t} for k < top: the ridge solve against z_{k+1,t}."""
        fixed = _project(rec[k + 1], h_above_prev)
        tgt = row4(zs[k], t) + row4(zduals[k], t) / rz3 - fixed
        rhs = (rho2.h * o_n * torch.tanh(c_n) - lam_h
               + rz2 * (inp[k + 1].mT @ tgt.reshape(lead + (-1, batch))))
        return m_invs[k] @ rhs

    def upper_layer_block(k, t, old, duals_t, h_below, h_prev, c_prev):
        """z -> gates -> c of upper layer k at step t; writes z, its dual
        and the gate and c duals, and returns (i, f, g, o, c)."""
        z_t, zdual_t = row4(zs[k - 1], t), row4(zduals[k - 1], t)
        lin = _project(inp[k], h_below) + _project(rec[k], h_prev)
        z_new = _z_prox_update(z_t, row4(u_slabs[k - 1], t),
                               lin - zdual_t / rz3, rho_g4, rz3, is_tanh4,
                               row4(resmaxes[k - 1], t))
        act4 = torch.where(is_tanh4, torch.tanh(z_new),
                           torch.sigmoid(z_new)).unbind(-3)

        _, f_o, g_o, _, c_o, h_o = old
        lam_i, lam_f, lam_g, lam_o, lam_c, lam_h = duals_t
        i_n = cf.gate_ifgo_update(lam_i, rho2.i, act4[0], g_o, f_o, c_prev,
                                  c_o, rho2.c, lam_c)
        f_n = cf.gate_ifgo_update(lam_f, rho2.f, act4[1], c_prev, g_o, i_n,
                                  c_o, rho2.c, lam_c)
        g_n = cf.gate_ifgo_update(lam_g, rho2.g, act4[2], i_n, f_n, c_prev,
                                  c_o, rho2.c, lam_c)
        o_n = cf.gate_ifgo_update(lam_o, rho2.o, act4[3], torch.tanh(c_o),
                                  0.0, 0.0, h_o, rho2.h, lam_h)
        c_n = cf.c_update(c_o, o_n, h_o, lam_h, lam_c, rho2.h, rho2.c,
                          f_n, c_prev, i_n, g_n)
        lams = (cf.dual_ifgo_update(lam_i, rho2.i, i_n, act4[0]),
                cf.dual_ifgo_update(lam_f, rho2.f, f_n, act4[1]),
                cf.dual_ifgo_update(lam_g, rho2.g, g_n, act4[2]),
                cf.dual_ifgo_update(lam_o, rho2.o, o_n, act4[3]),
                cf.dual_c_update(lam_c, rho2.c, c_n, f_n, c_prev, i_n, g_n))
        for dst, v in zip(new_duals[k], lams):
            dst[..., t, :, :] = damp(v)
        row4(new_zs[k - 1], t)[...] = z_new
        row4(new_zduals[k - 1], t)[...] = damp(zdual_t + rz3 * (z_new - lin))
        return i_n, f_n, g_n, o_n, c_n

    def rows(slabs, t):
        return tuple(s[..., t, :, :] for s in slabs)

    def slab(k):
        return x_im.new_zeros(lead + (seq_len + 1, hiddens[k], batch))

    # The epoch's products as (4H, D) row blocks.
    rec = [_rows(lp.wh) for lp in layers]
    inp = [None] + [_rows(lp.wx) for lp in layers[1:]]

    # The z-prox curvature bounds: max |act(z) - u| per (layer, t) over
    # the (4, H, B) block (each candidate's own: ([S,] T+1, 1, 1, 1)), in
    # one pass over the previous epoch's slabs; u is also the gate target.
    u_slabs, resmaxes = [], []
    for k in range(1, n):
        g_k, d_k = gates[k], duals[k]
        u = (torch.stack([g_k.i, g_k.f, g_k.g, g_k.o], dim=-3)
             + torch.stack([d_k.i, d_k.f, d_k.g, d_k.o], dim=-3)
             / rho_g4.unsqueeze(-4))
        z = zs[k - 1]
        act = torch.where(is_tanh4, torch.tanh(z), torch.sigmoid(z))
        resmaxes.append(torch.amax(torch.abs(act - u), dim=(-3, -2, -1),
                                   keepdim=True))
        u_slabs.append(u)

    xproj0 = torch.einsum('...tdb,...gdh->...tghb', x_im, layers[0].wx)
    new_gates = [[slab(k) for _ in range(6)] for k in range(n)]
    new_duals = [[slab(k) for _ in range(5)] for k in range(n)]
    new_zs = [torch.zeros_like(z) for z in zs]
    new_zduals = [torch.zeros_like(z) for z in zs]

    h_prev = [gates[k].h[..., 0, :, :] for k in range(n)]
    c_prev = [gates[k].c[..., 0, :, :] for k in range(n)]
    for t in range(1, seq_len + 1):
        final = t == seq_len
        g_t = [rows(gates[k][:6], t) for k in range(n)]
        d_t = [rows(duals[k][:6], t) for k in range(n)]
        # Layer 0: the single-layer treatment.
        pre0 = xproj0[..., t - 1, :, :, :] + _project(rec[0], h_prev[0])
        prim, lam0 = _timestep_primal_duals(pre0, g_t[0], d_t[0],
                                            c_prev[0], rho2)
        for dst, v in zip(new_duals[0], lam0):
            dst[..., t, :, :] = damp(v)
        prims, h_new = [prim], [None] * n
        for k in range(n):
            if k > 0:
                prims.append(upper_layer_block(k, t, g_t[k], d_t[k],
                                               h_new[k - 1], h_prev[k],
                                               c_prev[k]))
            o_n, c_n = prims[k][3], prims[k][4]
            if k < top:
                h_new[k] = coupled_h_solve(k, t, o_n, c_n, d_t[k][5],
                                           h_prev[k + 1])
            elif not final:
                h_new[k] = cf.h_interior_update(o_n, torch.tanh(c_n),
                                                d_t[k][5], rho2.h)
            for dst, v in zip(new_gates[k], prims[k] + (h_new[k],)):
                if v is not None:
                    dst[..., t, :, :] = v
        h_prev, c_prev = h_new, [p[4] for p in prims]
    return new_gates, new_duals, new_zs, new_zduals


def make_stacked_step(config: ADMMConfig):
    """The stacked epoch for a config (fast / no_dual_y):
    (state, (B, T, I), (B, O)) -> state."""
    rules = rules_for(config)

    def step(state, train_x, train_y):
        return stacked_admm_step(state, train_x, train_y, rules)

    return step


def train_stacked(train_x, train_y, val_x, val_y,
                  parameter_set: ParameterSet, config: ADMMConfig,
                  hidden2: int = 0, log_every: int = 10,
                  hiddens: Optional[Sequence[int]] = None,
                  track_best: bool = True,
                  params: Optional[StackedParams] = None,
                  device='cuda') -> Dict[str, object]:
    """N-layer ADMM training loop (JAX stacked.py:758-838).

    `hiddens` gives every layer's width; otherwise the stack is the
    2-layer (config.hidden_size, hidden2 or config.hidden_size).  `params`
    defaults to `init_stacked` from `torch.Generator().manual_seed(
    config.seed)`; the JAX package draws from `jax.random`, so parity
    carries its weights across (`stacked_params_from_dict`).  Arrays may
    be numpy or tensors; they are moved to `device` ('cuda' by default;
    the CPU only when asked).

    track_best returns the best-validation iterate as 'params' (and the
    last as 'final_params'), carried on the device.  The epochs run
    through core/loop.run_chunked, as `api.train`'s do, and under a
    profiler the run is a `train` span around its `init`, its epochs and
    `collect`.  Returns the dict of `api.train`: 'name', 'train_loss',
    'val_loss', 'residuals' (empty), 'params', 'final_params',
    'best_epoch', 'state', 'seconds'.
    """
    rules = rules_for(config)        # raises for the legacy variants
    device = resolve_device(device)
    if isinstance(parameter_set, dict):
        parameter_set = ParameterSet.from_dict(parameter_set)
    with matmul_precision(config.matmul_precision), span('train'):
        with span('init'):
            train_x, train_y = (as_tensor(train_x, device),
                                as_tensor(train_y, device))
            val_x, val_y = as_tensor(val_x, device), as_tensor(val_y, device)
            if hiddens is None:
                hiddens = ((config.hidden_size, hidden2 or config.hidden_size)
                           if params is None else
                           tuple(lp.hidden_size for lp in params.layers))
            hiddens = tuple(int(h) for h in hiddens)
            if params is None:
                params = init_stacked(
                    torch.Generator().manual_seed(config.seed),
                    train_x.shape[2], hiddens, train_y.shape[1],
                    device=device)
            elif hiddens != tuple(lp.hidden_size for lp in params.layers):
                raise ValueError(f'hiddens {hiddens} do not match the '
                                 f'widths of params')
            state = init_stacked_state(params, train_x, parameter_set,
                                       config)
            initial = (float(stacked_mse_loss(state.params, train_x,
                                              train_y)),
                       float(stacked_mse_loss(state.params, val_x, val_y)))
            x_im, y_im, xall_im, vy_im = batch_minor(train_x, train_y,
                                                     val_x, val_y)

        def epoch(st):
            st = stacked_admm_step_im(st, x_im, y_im, rules)
            with span('loss'):
                tr, vl = stacked_train_val_mse_im(st.params, xall_im, y_im,
                                                  vy_im)
            return st, {'train_loss': tr, 'val_loss': vl}

        result = {'name': 'Stacked ADMM-LSTM'}
        depth = 'x'.join(str(h) for h in hiddens)
        result.update(run_chunked(
            f'{len(hiddens)}-layer ADMM ({depth}) on {device}', state, epoch,
            initial, config.epochs, log_every=log_every,
            track_best=track_best))
    return result
