"""SL training of the port against ``bokego_tpu.train.sl``, at full width
(128 channels, as the trainers use) on the CPU, B=16.

Adam divides each gradient element by its own root mean square, so an
element whose gradient is near 0 (the biases that feed a BatchNorm, whose
gradient is 0 in real arithmetic; weights on sparse input planes) steps by
up to ``lr`` in a direction that fp32 rounding decides.  XLA and PyTorch
order their sums differently, so two runs of several steps drift apart by
a fraction of ``lr`` in those elements whatever the port does.  The parity
is therefore held step by step along the JAX package's trajectory: from
the same weights, BatchNorm statistics and optimizer state (carried across
with ``from_flax`` and ``adam_from_optax``, so steps 2 and 3 are resumed
runs), one step of the port's ``sl.train`` gives the same loss, gradients
and updated statistics, and the port's optimizer fed the JAX step's
gradients gives the same weights, all within rtol 1e-4 / atol 1e-5.

Gradients are compared at steps 1 and 2 only.  At step 3 the float32
gradient of the lower convolutions is not determined to 1e-5 by the
weights: both packages' differ from a float64 evaluation of the same step
beyond that on up to 1 % of ``conv.0``'s elements (the port's by up to
5e-5, the JAX package's, whose BatchNorm takes the variance in one pass as
E[x^2] - E[x]^2, by up to 4e-3 on values up to 0.9).  Step 3's loss,
statistics and update are compared all the same."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bokego_tpu import features as jfeatures
from bokego_tpu.env import rules as jrules
from bokego_tpu.models import nets as jnets
from bokego_tpu.train import data as jdata
from bokego_tpu.train import sl as jsl
from bokego_tpu_torch.models import convert, nets
from bokego_tpu_torch.train import data as tdata
from bokego_tpu_torch.train import sl
from tests.torch_port_util import random_actions, random_positions

RTOL, ATOL = 1e-4, 1e-5
B, LR = 16, 1e-3
_jfeat = jax.jit(jfeatures.features_batch)
_jlegal = jax.jit(jrules.legal_mask_batch)


def _positions(seed: int, n: int):
    """Packed arrays, features and move/value targets of seeded positions."""
    js = random_positions(seed, n, 14 + seed % 5, pass_prob=0.03)
    rng = np.random.default_rng(seed)
    moves = random_actions(rng, np.asarray(_jlegal(js)), pass_prob=0.0)
    packed = dict(
        boards=np.asarray(js.board).astype(np.uint8), ko=np.asarray(js.ko).astype(np.int16),
        last=np.asarray(js.last_move).astype(np.int16), turn=(np.asarray(js.turn) % 2).astype(np.int8),
    )
    vals = rng.choice([-1.0, 1.0], n).astype(np.float32)
    return packed, np.asarray(_jfeat(js)), moves.astype(np.int32), vals


def _datasets(kind: str, seed: int, n: int):
    """(JAX dataset, port dataset) of the same positions: packed for the
    policy (features on the device per batch), in memory for the value."""
    packed, fts, moves, vals = _positions(seed, n)
    if kind == "policy":
        return (jdata.PackedDataset(**packed, targets=moves, is_value=False),
                tdata.PackedDataset(**packed, targets=moves, is_value=False))
    return jdata.GoDataset(fts, vals, True), tdata.GoDataset(fts, vals, True)


def _flax_vars(kind: str, seed: int):
    init = jnets.init_policy if kind == "policy" else jnets.init_value
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))


_GRAD_FNS = {}


def _jax_grad(kind: str):
    """Jitted (loss, new batch stats), grads of the JAX package's loss, one
    per kind for the whole module."""
    if kind not in _GRAD_FNS:
        net = jnets.ValueNet() if kind == "value" else jnets.PolicyNet()
        loss_fn = jsl.make_value_loss(net) if kind == "value" else jsl.make_policy_loss(net)
        _GRAD_FNS[kind] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return _GRAD_FNS[kind]


class _OneBatch:
    """A dataset of one fixed batch (``sl.train`` takes any ``batches``)."""

    def __init__(self, fts, targets):
        self.fts, self.targets = fts, targets

    def batches(self, batch_size, rng, augment=True, device=None):
        yield self.fts, self.targets


def _net(kind, params, stats):
    net = (nets.PolicyNet if kind == "policy" else nets.ValueNet)()
    net.load_state_dict(convert.from_flax({"params": params, "batch_stats": stats}))
    return net


def _close(got: dict, want: dict, what: str):
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(), rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("kind", ["policy", "value"])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2], ids=["adam", "adamw"])
def test_sl_steps_match_jax(kind, weight_decay):
    variables = _flax_vars(kind, 3)
    jds, tds = _datasets(kind, 5, 3 * B)
    jbatches = list(jds.batches(B, np.random.default_rng(7)))
    tbatches = list(tds.batches(B, np.random.default_rng(7), device="cpu"))
    tx = optax.adamw(LR, weight_decay=weight_decay) if weight_decay else optax.adam(LR)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    for i, ((jf, jt), (tf, tt)) in enumerate(zip(jbatches, tbatches)):
        np.testing.assert_array_equal(tf.numpy() if torch.is_tensor(tf) else tf, np.asarray(jf))
        (loss, new_stats), grads = _jax_grad(kind)(params, stats, jnp.asarray(jf), jnp.asarray(jt))
        updates, next_opt = tx.update(grads, opt_state, params)
        next_params = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
        new_stats = jax.tree.map(np.asarray, new_stats)

        # one step of the port's sl.train from the same point (a resumed
        # run from step 2 on)
        net = _net(kind, params, stats)
        resume = None if i == 0 else convert.adam_from_optax(opt_state, net)
        state = sl.train(_OneBatch(tf, tt), net, kind=kind, batch_size=B, lr=LR, weight_decay=weight_decay,
                         opt_state=resume, start_epoch=i, log_every=1, log_fn=lambda _: None)
        assert state.epoch == i + 1 and not net.training
        assert type(state.optimizer) is (torch.optim.AdamW if weight_decay else torch.optim.Adam)
        assert float(state.optimizer.state_dict()["state"][0]["step"]) == i + 1
        np.testing.assert_allclose(state.losses, [float(loss)], rtol=RTOL, atol=ATOL)
        want_grads = convert._tensors(convert._net_sd(jax.tree.map(np.asarray, grads), None))
        if i < 2:  # step 3's float32 gradient is not determined to 1e-5 (module docstring)
            _close({n: p.grad for n, p in net.named_parameters()}, want_grads, f"step {i + 1} gradient")
        want_stats = convert.from_flax({"params": params, "batch_stats": new_stats})
        _close(net.state_dict(), {k: v for k, v in want_stats.items() if "running" in k}, f"step {i + 1}")

        # the port's optimizer fed the JAX step's gradients lands where optax does
        net = _net(kind, params, stats)
        opt = sl.make_optimizer(net, LR, weight_decay)
        if i:
            sl.load_optimizer_state(opt, convert.adam_from_optax(opt_state, net))
        for n, p in net.named_parameters():
            p.grad = want_grads[n].clone()
        opt.step()
        _close(dict(net.named_parameters()), convert._tensors(convert._net_sd(next_params, None)), f"step {i + 1} update")
        params, stats, opt_state = next_params, new_stats, next_opt
    # the statistics moved off their initial values
    assert float(net.state_dict()["conv.1.running_var"].sub(1.0).abs().max()) > 1e-3


def test_sl_train_epoch_runs_the_jax_batches():
    """A whole epoch through ``sl.train``: 3 steps on the batches the JAX
    package draws from the same seed, the first loss equal to JAX's (later
    ones drift with Adam, module docstring), losses logged and stats
    written per epoch."""
    kind = "policy"
    variables = _flax_vars(kind, 4)
    jds, tds = _datasets(kind, 6, 3 * B + 5)
    jf, jt = next(jds.batches(B, np.random.default_rng(2)))
    (loss, _), _ = _jax_grad(kind)(variables["params"], variables["batch_stats"], jnp.asarray(jf), jnp.asarray(jt))
    logs = []
    state = sl.train(tds, _net(kind, variables["params"], variables["batch_stats"]), kind=kind, batch_size=B,
                     lr=LR, seed=2, log_every=1, log_fn=logs.append, start_epoch=3)
    assert state.epoch == 4 and len(state.losses) == 3
    np.testing.assert_allclose(state.losses[0], float(loss), rtol=RTOL, atol=ATOL)
    assert [line.split(":")[0] for line in logs[:3]] == [f"epoch 4 step {i}" for i in (1, 2, 3)]
    assert logs[3].startswith("epoch 4 done in") and "ms/step" in logs[3]


def test_batchnorm_fed_bias_gradients_are_rounding_noise():
    """The gradient of a bias that feeds a train-mode BatchNorm is 0 up to
    rounding in the port: the elements whose Adam steps rounding decides
    (module docstring)."""
    _, tds = _datasets("value", 9, B)
    net = nets.ValueNet().train()
    fts, vals = next(tds.batches(B, np.random.default_rng(0)))
    sl.value_loss(net, torch.from_numpy(np.ascontiguousarray(fts)), torch.from_numpy(vals)).backward()
    noise = max(float(net.conv[i].bias.grad.abs().max()) for i in (0, 3, 6, 9, 12, 15, 18))
    assert max(noise, float(net.lin1.bias.grad.abs().max())) < 1e-6
    assert float(net.conv[0].weight.grad.abs().max()) > 1e-4


def test_lin_bn_running_variance_is_biased_as_flax():
    """``lin_bn`` at B=8: the port's running variance is Flax's (biased
    batch variance); torch's stock ``BatchNorm1d`` (unbiased) is 8/7 off."""
    x = np.random.default_rng(0).normal(size=(8, 64)).astype(np.float32) * 2 + 1
    bn = jnets.nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    fvars = bn.init(jax.random.PRNGKey(0), x)
    fy, upd = bn.apply(fvars, x, mutable=["batch_stats"])
    want_var = np.asarray(upd["batch_stats"]["var"])
    want_mean = np.asarray(upd["batch_stats"]["mean"])

    port = nets.BatchNorm1d(64, eps=1e-5, momentum=0.1).train()
    y = port(torch.from_numpy(x))
    np.testing.assert_allclose(port.running_var.numpy(), want_var, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port.running_mean.numpy(), want_mean, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(fy), rtol=RTOL, atol=ATOL)

    stock = torch.nn.BatchNorm1d(64, eps=1e-5, momentum=0.1).train()
    stock(torch.from_numpy(x))
    assert not np.allclose(stock.running_var.numpy(), want_var, rtol=RTOL, atol=ATOL)
    # eval mode is the stock layer's: the running statistics
    port.eval()
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               torch.nn.functional.batch_norm(torch.from_numpy(x), port.running_mean, port.running_var,
                                                              port.weight, port.bias, eps=1e-5).detach().numpy())


def test_value_from_policy_copies_the_trunk():
    pvars, vvars = _flax_vars("policy", 1), _flax_vars("value", 2)
    want = convert.from_flax(jax.tree.map(np.asarray, jnets.value_from_policy(vvars, pvars)))
    value = nets.ValueNet()
    value.load_state_dict(convert.from_flax(vvars))
    policy = nets.PolicyNet()
    policy.load_state_dict(convert.from_flax(pvars))
    assert nets.value_from_policy(value, policy) is value
    for k, v in value.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_multi_device_sl_raises():
    """Data-parallel SL runs in one process per rank: without a process
    group it raises and names the launcher (``tests/test_torch_parallel.py``
    runs it)."""
    _, tds = _datasets("value", 10, B)
    with pytest.raises(RuntimeError, match="parallel.mesh.spawn"):
        sl.train(tds, nets.ValueNet(8), n_devices=2)
