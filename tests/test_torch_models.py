"""Port parity: nets, weight carry-over and the real-net root evaluation.

Tolerance 1e-5 (absolute) on logits, probabilities and values: both sides
compute in float32 on the CPU, but XLA and PyTorch order the convolution
sums differently."""

import os

import numpy as np
import pytest
import torch

import jax

from bokego_tpu import features as jfeatures
from bokego_tpu.config import SearchConfig as JConfig
from bokego_tpu.env import state as jst
from bokego_tpu.models import convert as jconvert
from bokego_tpu.models import inference as jinference
from bokego_tpu.models import nets as jnets
from bokego_tpu.search import mcts as jmcts
from bokego_tpu_torch.config import SearchConfig as TConfig
from bokego_tpu_torch.models import convert as tconvert
from bokego_tpu_torch.models import inference as tinference
from bokego_tpu_torch.models import nets as tnets
from bokego_tpu_torch.search import mcts as tmcts
from tests.torch_port_util import random_positions, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALUE_R2 = os.path.join(REPO, "data", "weights", "value_r2.pt")
ATOL = 1e-5
CH = 16


def _flax_vars(kind: str, seed: int) -> dict:
    """Small-width Flax variables as numpy dicts, with the BatchNorm
    parameters and statistics randomised so the mapping of each is tested."""
    init = jnets.init_policy if kind == "policy" else jnets.init_value
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), channels=CH))
    rng = np.random.default_rng(seed)

    def randomise(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                randomise(v, path + (k,))
            elif any(p.startswith("bn") for p in path):
                lo = 0.5 if k in ("var", "scale") else -0.5
                tree[k] = rng.uniform(lo, lo + 1.0, v.shape).astype(np.float32)
            elif k == "untied_bias":
                tree[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)

    randomise(variables)
    return variables


def _port_net(kind: str, variables: dict):
    net = (tnets.PolicyNet if kind == "policy" else tnets.ValueNet)(CH)
    net.load_state_dict(tconvert.from_flax(variables))
    return net.eval()


def _features(seed: int) -> np.ndarray:
    return np.asarray(jfeatures.features_batch(random_positions(seed, 8, 30, pass_prob=0.05)))


@pytest.mark.parametrize("kind", ["policy", "value"])
def test_from_flax_nets_match_jax(kind):
    variables = _flax_vars(kind, seed=3)
    fts = _features(8)
    net = _port_net(kind, variables)
    x = torch.from_numpy(fts)
    if kind == "policy":
        want = np.asarray(jnets.PolicyNet(channels=CH).apply(variables, fts, train=False))
        got = net(x).detach().numpy()
        np.testing.assert_allclose(
            tinference.policy_probs(net, x).numpy(),
            np.asarray(jax.nn.softmax(want, axis=-1)),
            rtol=0, atol=ATOL,
        )
    else:
        want = np.asarray(jnets.ValueNet(channels=CH).apply(variables, fts, train=False))[:, 0]
        got = tinference.value_fn(net, x).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_value_r2_loads_and_matches_jax():
    """The shipped reference checkpoint loads with ``load_state_dict`` and no
    conversion, and agrees with the JAX package's converted copy."""
    net = tnets.load_value(VALUE_R2, device="cpu")
    sd = torch.load(VALUE_R2, map_location="cpu", weights_only=True)["model_state_dict"]
    assert len(sd) == 65 and tuple(sd["conv.0.weight"].shape) == (128, 27, 5, 5)
    fts = _features(9)
    want = np.asarray(jinference.value_fn(jconvert.load_value(VALUE_R2), fts))
    got = tinference.value_fn(net, torch.from_numpy(fts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_policy_17_export_matches_jax():
    """The committed export ``data/weights/policy_17.pt`` loads into the
    port's ``PolicyNet`` and gives the logits of the JAX package on the orbax
    checkpoint it was exported from: within 1e-5 absolute plus 1e-5 relative
    (trained logits reach a magnitude of 18, where 1e-5 is 5 float32 ulps and
    the two convolution sum orders differ by more), and the probabilities
    within 1e-5 absolute."""
    from bokego_tpu.train import checkpoints
    from bokego_tpu_torch.config import POLICY_WEIGHTS

    net = tnets.load_policy(POLICY_WEIGHTS, device="cpu")
    assert isinstance(net, tnets.PolicyNet) and not net.training
    variables = checkpoints.load_variables(os.path.join(REPO, "data", "weights", "policy_17_flax"))
    fts = _features(11)
    want = np.asarray(jinference.policy_logits(variables, fts))
    got = net(torch.from_numpy(fts)).detach().numpy()
    assert float(np.abs(want).max()) > 1.0  # trained logits, not a zero net
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(
        tinference.policy_probs(net, torch.from_numpy(fts)).numpy(),
        np.asarray(jinference.policy_probs(variables, fts)), rtol=0, atol=ATOL,
    )
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_repo_trained_exports_match_jax():
    """The committed exports of the repo's own strongest pair,
    ``data/weights/rl8_policy.pt`` (from the orbax ``rl_pool/policy_8``) and
    ``data/weights/value_own.pt`` (from ``value_own``), load into the port
    and give the JAX package's logits (the tolerance of the ``policy_17``
    test above) and values (1e-5 absolute) on the orbax checkpoints."""
    from bokego_tpu.train import checkpoints

    weights = os.path.join(REPO, "data", "weights")
    fts = _features(12)
    policy = tnets.load_policy(os.path.join(weights, "rl8_policy.pt"), device="cpu")
    pvars = checkpoints.load_variables(os.path.join(weights, "rl_pool", "policy_8"))
    want = np.asarray(jinference.policy_logits(pvars, fts))
    got = policy(torch.from_numpy(fts)).detach().numpy()
    assert float(np.abs(want).max()) > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))

    value = tnets.load_value(os.path.join(weights, "value_own.pt"), device="cpu")
    vvars = checkpoints.load_variables(os.path.join(weights, "value_own"))
    want = np.asarray(jinference.value_fn(vvars, fts))
    got = tinference.value_fn(value, torch.from_numpy(fts)).numpy()
    assert float(np.abs(want).max()) > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_gen0_export_matches_jax():
    """``data/weights/rl0_policy.pt``, the export of the REINFORCE pool's
    generation 0 (``rl_pool/policy_0``, the SL seed) that the policy curve
    plays on the card, gives the JAX package's logits on the orbax
    checkpoint (the tolerance of the tests above), and is another net than
    generation 8's."""
    from bokego_tpu.train import checkpoints

    weights = os.path.join(REPO, "data", "weights")
    fts = _features(13)
    policy = tnets.load_policy(os.path.join(weights, "rl0_policy.pt"), device="cpu")
    pvars = checkpoints.load_variables(os.path.join(weights, "rl_pool", "policy_0"))
    want = np.asarray(jinference.policy_logits(pvars, fts))
    got = policy(torch.from_numpy(fts)).detach().numpy()
    assert float(np.abs(want).max()) > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    gen8 = tnets.load_policy(os.path.join(weights, "rl8_policy.pt"), device="cpu")
    assert float((gen8(torch.from_numpy(fts)).detach() - torch.from_numpy(got)).abs().max()) > 0.1


def test_exports_are_not_pool_members(tmp_path):
    """No shipped or exported ``.pt`` under ``data/weights`` counts as an
    opponent-pool generation, even under a ``policy_<n>.pt`` name; a file
    that the pool wrote does."""
    import shutil

    from bokego_tpu_torch.train import checkpoints as tckpt

    weights = os.path.join(REPO, "data", "weights")
    exports = sorted(f for f in os.listdir(weights) if f.endswith(".pt"))
    assert {"policy_17.pt", "rl8_policy.pt", "value_own.pt", "value_r2.pt"} <= set(exports)
    for i, name in enumerate(exports):
        shutil.copy(os.path.join(weights, name), tmp_path / f"policy_{i + 1}.pt")
    assert tckpt.pool_ids(str(tmp_path)) == []
    assert tckpt.save_next_policy(str(tmp_path), tnets.init_policy(8, seed=0, device="cpu")) == 0
    assert tckpt.pool_ids(str(tmp_path)) == [0]


def _jax_evaluator():
    """JAX evaluator over small-width nets (the package's net_evaluator
    applies the default 128-channel modules)."""
    pol, val = jnets.PolicyNet(channels=CH), jnets.ValueNet(channels=CH)

    def evaluate(params, states):
        fts = jfeatures.features_batch(states)
        probs = jax.nn.softmax(pol.apply(params["policy"], fts, train=False), axis=-1)
        return probs, val.apply(params["value"], fts, train=False)[..., 0]

    return jmcts.Evaluator(
        evaluate=evaluate, policy_probs=lambda p, s: evaluate(p, s)[0], has_value=True
    )


def test_init_trees_real_net_matches_jax():
    """Root priors and values from the converted 16-channel nets agree with
    the JAX package's ``init_trees`` within 1e-5; the tree structure is exact."""
    pv, vv = _flax_vars("policy", 4), _flax_vars("value", 5)
    js = random_positions(10, 8, 12)
    base = dict(expand_thresh=100, no_sim=True, max_nodes=128, eval_every=8, kernel_levels=6)
    jt = jmcts.init_trees(
        jax.random.PRNGKey(0), js, _jax_evaluator(), {"policy": pv, "value": vv},
        JConfig(**base, use_kernel=False),
    )
    params = {"policy": _port_net("policy", pv), "value": _port_net("value", vv)}
    tt = tmcts.init_trees(to_port(js), tmcts.net_evaluator(), params, TConfig(**base, use_kernel=True))
    jp, tp = np.asarray(jt.pstats), tt.pstats.numpy()
    np.testing.assert_allclose(tp[:, 0, 3], jp[:, 0, 3], rtol=0, atol=ATOL)  # C_PRIOR
    np.testing.assert_allclose(tt.value[:, 0].numpy(), np.asarray(jt.value)[:, 0], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(np.delete(tp, 3, axis=2), np.delete(jp, 3, axis=2))
    np.testing.assert_array_equal(tt.n_nodes.numpy(), np.asarray(jt.n_nodes))


def test_policy_v2_matches_jax():
    """The legacy ``PolicyNetV2`` (fixed widths 64 and 128, no BatchNorm)
    after ``policy_v2_from_flax``: logits within 1e-5 of the Flax net, and
    the state dict is the inverse of the JAX package's
    ``policy_v2_from_torch``."""
    rng = np.random.default_rng(5)
    variables = jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(0.0, 0.02, x.shape)).astype(np.float32),
        jnets.PolicyNetV2().init(jax.random.PRNGKey(5), np.zeros((1, 9, 9, 27), np.float32)),
    )
    net = tnets.PolicyNetV2()
    state = tconvert.policy_v2_from_flax(variables)
    net.load_state_dict(state)
    fts = _features(9)
    want = np.asarray(jinference.policy_logits_v2(variables, fts))
    got = tinference.policy_logits_v2(net.eval(), torch.from_numpy(np.array(fts))).numpy()
    assert got.shape == (8, 81) and float(np.abs(want).max()) > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    back = jconvert.policy_v2_from_torch(state)["params"]
    for (path, a), (_, b) in zip(
        jax.tree_util.tree_leaves_with_path(back), jax.tree_util.tree_leaves_with_path(dict(variables["params"]))
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def _pooled_inits(kind: str, seeds: int):
    """State dicts of ``seeds`` fresh 128-channel nets of ``kind``, seeds
    ``0 .. seeds-1``: the port's (``init_policy`` / ``init_value``, or
    ``PolicyNetV2()`` under ``torch.manual_seed``) and, but for ``v2``,
    the JAX package's init in the port's key layout."""
    if kind == "v2":
        port = []
        with torch.random.fork_rng(devices=[]):
            for s in range(seeds):
                torch.manual_seed(s)
                port.append(tnets.PolicyNetV2().state_dict())
        return port, None
    tinit = tnets.init_policy if kind == "policy" else tnets.init_value
    port = [tinit(128, seed=s, device="cpu").state_dict() for s in range(seeds)]
    jinit = jax.jit(jax.vmap(jnets.init_policy if kind == "policy" else jnets.init_value))
    ref = []
    for lo in range(0, seeds, 16):
        batch = jax.tree.map(np.asarray, jinit(jax.numpy.stack([jax.random.PRNGKey(s) for s in range(lo, lo + 16)])))
        ref += [tconvert.from_flax(jax.tree.map(lambda x, i=i: x[i], batch)) for i in range(16)]
    return port, ref[:seeds]


@pytest.mark.parametrize("kind, seeds", [("policy", 32), ("value", 64), ("v2", 32)])
def test_random_init_draws_as_flax(kind, seeds):
    """A fresh net draws from Flax's default initialisers, as the JAX nets'
    ``init`` does: each kernel's sample std within 3 % of sqrt(1 / fan_in)
    and of the same layer of the JAX init (``PolicyNetV2``: the former
    alone), no entry beyond the cut at 2 sigma, every bias and untied bias
    exactly 0, BatchNorm at scale 1, bias 0, mean 0, variance 1.  Each
    compared sample holds at least 4096 entries: a tensor smaller than that
    (the 1x1 heads, ``lin2``) is pooled over as many seeds as that takes,
    16 or more."""
    port, ref = _pooled_inits(kind, seeds)
    kernels = [k for k, w in port[0].items() if k.endswith("weight") and w.dim() >= 2]
    assert len(kernels) == {"policy": 8, "value": 10, "v2": 7}[kind]
    for key in kernels:
        fan_in = port[0][key][0].numel()
        want = (1.0 / fan_in) ** 0.5
        n = 1 if port[0][key].numel() >= 4096 else max(16, -(-4096 // port[0][key].numel()))
        assert n <= seeds
        got = torch.cat([sd[key].flatten() for sd in port[:n]])
        assert abs(float(got.std()) / want - 1.0) < 0.03, (key, float(got.std()) / want)
        assert float(got.abs().max()) <= 2.0 * want / 0.87962566103423978, key
        if ref is not None:
            jax_std = float(torch.cat([torch.as_tensor(np.asarray(sd[key])).flatten() for sd in ref[:n]]).std())
            assert abs(float(got.std()) / jax_std - 1.0) < 0.03, (key, float(got.std()) / jax_std)
    for key, t in port[0].items():
        if key in kernels or key.endswith("num_batches_tracked"):
            continue
        one = key.endswith("running_var") or (key.endswith("weight") and t.dim() == 1)
        assert torch.equal(t, torch.full_like(t, 1.0 if one else 0.0)), key


def test_random_init_logits_spread_as_jax():
    """The empty-board policy logits of the port's ``init_policy(seed=s)``
    spread as the JAX ``init_policy(PRNGKey(s))``'s: the std over the 81
    points, averaged over seeds 0-3, within 0.5-2x of the JAX init's."""
    fts = np.array(jfeatures.features_batch(jst.new_game_batch(1)))
    port = np.mean([
        float(tnets.init_policy(128, seed=s, device="cpu")(torch.from_numpy(fts)).detach().std()) for s in range(4)
    ])
    logits = jax.jit(lambda key: jnets.PolicyNet().apply(jnets.init_policy(key), fts, train=False))
    ref = np.mean([float(np.std(np.asarray(logits(jax.random.PRNGKey(s))), ddof=1)) for s in range(4)])
    assert 0.5 < port / ref < 2.0, (port, ref)
