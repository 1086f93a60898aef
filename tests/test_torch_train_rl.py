"""The port's data generation, REINFORCE and AlphaZero against the JAX
package on the CPU.

Self-play is held exactly (tolerance 0) where the draws cannot matter:
through the one-hot policy-net stand-in ``tests/torch_fake_eval.
OneHotPolicyNet`` (its JAX twin is patched in for
``bokego_tpu.models.inference.policy_probs``) for ``gendata.generate`` and
``reinforce.play_games``, and with the deterministic evaluator at
temperature 0 without root noise for ``selfplay_with_targets``.  The losses
and updates are held on the same trajectory, the JAX one carried over:
losses and gradients within rtol 1e-4 / atol 1e-5, and the port's AdamW fed
the JAX step's gradients lands on optax's weights within the same
tolerance.  genvals draws r and the random move from other generators than
the JAX package, so its samples are checked for what they must satisfy."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bokego_tpu.config import SearchConfig as JConfig
from bokego_tpu.coords import NN as JNN
from bokego_tpu.models import inference as jinference
from bokego_tpu.models import nets as jnets
from bokego_tpu.train import alphazero as jaz
from bokego_tpu.train import gendata as jgendata
from bokego_tpu.train import reinforce as jreinforce
from bokego_tpu_torch.config import SearchConfig
from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.env import rules, state as st
from bokego_tpu_torch.models import convert, nets
from bokego_tpu_torch.search import playout as po
from bokego_tpu_torch.train import alphazero as az
from bokego_tpu_torch.train import gendata, genvals, reinforce
from tests.test_mcts import fake_evaluator as jax_fake_evaluator
from tests.torch_fake_eval import OneHotPolicyNet, fake_evaluator
from tests.torch_port_util import assert_states_equal, to_port

RTOL, ATOL = 1e-4, 1e-5


def jax_onehot_probs(offset, fts):
    """The JAX twin of ``OneHotPolicyNet(offset)`` after a softmax; stands
    in for ``inference.policy_probs(variables, fts)`` with the offset as
    the variables."""
    flat = fts.reshape(fts.shape[0], JNN, fts.shape[-1])
    mine = jnp.where(flat[:, :1, 3] > 0, 1, 2)
    board = jnp.where(flat[..., 0] > 0, mine, jnp.where(flat[..., 1] > 0, 3 - mine, 0))
    legal = flat[..., 5] > 0
    pick = (jnp.sum(board * jnp.arange(1, JNN + 1), -1) + offset) % jnp.maximum(legal.sum(-1), 1)
    return (legal & (jnp.cumsum(legal, -1) == pick[:, None] + 1)).astype(jnp.float32)


@pytest.fixture
def onehot_jax(monkeypatch):
    monkeypatch.setattr(jinference, "policy_probs", jax_onehot_probs)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _port_traj(jtraj) -> po.Trajectory:
    return po.Trajectory(
        states=to_port(jtraj.states), actions=torch.from_numpy(np.asarray(jtraj.actions, np.int64)),
        final=to_port(jtraj.final),
    )


@pytest.mark.parametrize("opponent", [None, 5])
def test_gendata_generate_matches_jax(onehot_jax, opponent):
    jtraj = jgendata.generate(jax.random.PRNGKey(0), 0, 6, max_turns=14, opponent_vars=opponent)
    opp = None if opponent is None else OneHotPolicyNet(opponent)
    ttraj = gendata.generate(_gen(1), OneHotPolicyNet(0), 6, max_turns=14, opponent=opp)
    np.testing.assert_array_equal(ttraj.actions.numpy(), np.asarray(jtraj.actions))
    assert_states_equal(jtraj.final, ttraj.final)
    assert_states_equal(jax.tree.map(lambda x: x[9], jtraj.states), ttraj.states.map(lambda x: x[9]))
    assert gendata.trajectory_to_rows(ttraj) == jgendata.trajectory_to_rows(jtraj)
    assert len(set(ttraj.actions[3].tolist())) == 1  # one-hot play: every board the same


@pytest.mark.parametrize("as_black", [True, False])
def test_play_games_matches_jax(onehot_jax, as_black):
    jtraj, jr = jreinforce.play_games(jax.random.PRNGKey(0), 0, 3, batch=4, max_turns=20, train_as_black=as_black)
    ttraj, tr_ = reinforce.play_games(_gen(2), OneHotPolicyNet(0), OneHotPolicyNet(3), 4, 20, as_black)
    np.testing.assert_array_equal(ttraj.actions.numpy(), np.asarray(jtraj.actions))
    assert_states_equal(jtraj.final, ttraj.final)
    np.testing.assert_array_equal(tr_.numpy(), np.asarray(jr))


def _rl_trajectory(monkeypatch_ctx, batch=4, max_turns=10):
    """A JAX play_games trajectory of two distinct one-hot policies and
    rewards of both signs."""
    with monkeypatch_ctx() as mp:
        mp.setattr(jinference, "policy_probs", jax_onehot_probs)
        jtraj, _ = jreinforce.play_games(jax.random.PRNGKey(0), 0, 7, batch=batch, max_turns=max_turns, train_as_black=True)
    rewards = jnp.asarray(np.where(np.arange(batch) % 2 == 0, 1.0, -1.0), jnp.float32)
    return jtraj, rewards


def _variables(kind: str, seed: int):
    init = jnets.init_policy if kind == "policy" else jnets.init_value
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))


def _net(kind: str, variables):
    net = (nets.PolicyNet if kind == "policy" else nets.ValueNet)()
    net.load_state_dict(convert.from_flax(variables))
    return net.eval()


def _sd(tree):
    return convert._tensors(convert._net_sd(jax.tree.map(np.asarray, tree), None))


def _close(got: dict, want: dict, what: str):
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(), rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")


def _step_with(opt, net, grads_sd):
    """One step of the port's optimizer fed the JAX gradients."""
    for n, p in net.named_parameters():
        p.grad = grads_sd[n].clone()
    opt.step()


_JAX_REINFORCE = jax.jit(jax.value_and_grad(jreinforce.reinforce_loss))  # one compile for both parities


@pytest.mark.parametrize("parity", [0, 1])
def test_reinforce_loss_and_update_match_jax(parity):
    jtraj, jrewards = _rl_trajectory(pytest.MonkeyPatch.context)
    variables = _variables("policy", 11)
    params, stats = variables["params"], variables["batch_stats"]
    jloss, jgrads = _JAX_REINFORCE(params, stats, jtraj, jrewards, jnp.int32(parity))
    ttraj, trewards = _port_traj(jtraj), torch.tensor(np.asarray(jrewards))

    net = _net("policy", variables)
    opt = reinforce.make_optimizer(net, lr=1e-3)
    loss = reinforce.update(net, opt, ttraj, trewards, parity)
    assert not net.training and isinstance(opt, torch.optim.AdamW) and opt.defaults["weight_decay"] == 1e-4
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL, atol=ATOL)
    _close({n: p.grad for n, p in net.named_parameters()}, _sd(jgrads), "gradient")
    # BatchNorm statistics untouched (eval mode), and the update with the
    # JAX gradients lands where optax.adamw(1e-3) does
    _close(net.state_dict(), {k: v for k, v in convert.from_flax(variables).items() if "running" in k}, "stats")
    tx = optax.adamw(1e-3)
    upd, _ = tx.update(jgrads, tx.init(params), params)
    fresh = _net("policy", variables)
    _step_with(reinforce.make_optimizer(fresh, lr=1e-3), fresh, _sd(jgrads))
    _close(dict(fresh.named_parameters()), _sd(optax.apply_updates(params, upd)), "update")


def test_reinforce_train_epoch_runs_both_colours():
    """Ten iterations: twenty colour batches and winrates, the net moved by
    its own AdamW, a log line per ten iterations."""
    net, opp = nets.PolicyNet(8), nets.PolicyNet(8)
    before = [p.detach().clone() for p in net.parameters()]
    logs = []
    res = reinforce.train_epoch(_gen(3), net.eval(), opp.eval(), n_iters=10, batch_games=2, max_turns=6, lr=1e-3,
                                log_fn=logs.append)
    assert len(res.winrates) == 20 and set(res.winrates) <= {0.0, 0.5, 1.0}
    assert logs and logs[0].startswith("iter 10: winrate")
    assert any(not torch.equal(a, b) for a, b in zip(before, net.parameters()))


AZ_CFG = dict(expand_thresh=2, no_sim=True, max_nodes=128, noise_weight=0.0, max_turns=12)


@pytest.fixture(scope="module")
def az_trajectories():
    jtraj = jax.jit(
        lambda r: jaz.selfplay_with_targets(r, jax_fake_evaluator(), None, JConfig(**AZ_CFG), 3, 7, 10)
    )(jax.random.PRNGKey(0))
    ttraj = az.selfplay_with_targets(_gen(0), fake_evaluator(), None, SearchConfig(**AZ_CFG), 3, 7, 10, device="cpu")
    return jtraj, ttraj


def test_selfplay_with_targets_matches_jax(az_trajectories):
    """Temperature 0, no noise: the same states, visit distributions, live
    masks and final positions, exactly."""
    jtraj, ttraj = az_trajectories
    assert_states_equal(jtraj.states, ttraj.states)
    assert_states_equal(jtraj.final, ttraj.final)
    np.testing.assert_array_equal(ttraj.dists.numpy(), np.asarray(jtraj.dists))
    np.testing.assert_array_equal(ttraj.live.numpy(), np.asarray(jtraj.live))
    assert float(ttraj.dists[0].sum(-1).min()) == pytest.approx(1.0)


def test_selfplay_with_targets_samples_by_visits():
    """Temperature > 0: the moves of the first ``temp_moves`` plies are
    drawn among the visited points, greedy after; done boards pass."""
    cfg = SearchConfig(**{**AZ_CFG, "noise_weight": 0.25, "max_turns": 4})
    traj = az.selfplay_with_targets(_gen(4), fake_evaluator(), None, cfg, 4, 6, 8, temperature=1.0, temp_moves=2,
                                    device="cpu")
    assert bool((traj.dists[:2].sum(-1) > 0.999).all())
    assert not bool(traj.live[-1].any())  # max_turns 4: every game over before the last move
    for t in range(traj.live.shape[0] - 1):
        moved = (traj.states.board[t + 1] != traj.states.board[t]).any(-1)
        played = traj.states.last_move[t + 1]
        real = moved & traj.live[t]
        assert bool((traj.dists[t][real, played[real]] > 0).all()), t  # a visited point
        assert not bool(moved[~traj.live[t]].any())  # done boards pass


def test_sample_by_visits_follows_the_tempered_visits():
    """The Gumbel maximum draws each visited point with probability
    ``visits ** (1 / T)`` over their sum; a row without a visit passes."""
    gen = torch.Generator().manual_seed(0)
    visits = torch.zeros(2, 81)
    points = [3, 10, 40]
    visits[0, points] = torch.tensor([1.0, 3.0, 6.0])
    n = 20000
    rows = visits.repeat(n, 1)  # the visited row and the empty one in turns
    for temperature in (1.0, 0.5):
        actions = az._sample_by_visits(az.gumbel(gen, 2 * n, "cpu"), rows, temperature)
        assert bool((actions[1::2] == az.PASS_ACTION).all())
        freq = torch.bincount(actions[0::2], minlength=82).float() / n
        want = visits[0, points] ** (1 / temperature)
        assert float(freq[points].sum()) == 1.0
        assert float((freq[points] - want / want.sum()).abs().max()) < 0.015  # > 4 standard errors


def test_az_losses_and_step_match_jax(az_trajectories):
    jtraj, ttraj = az_trajectories
    pvars, vvars = _variables("policy", 1), _variables("value", 2)
    pp, ps, vp, vs = pvars["params"], pvars["batch_stats"], vvars["params"], vvars["batch_stats"]
    jpl, jvl = jax.jit(jaz.az_losses)(pp, ps, vp, vs, jtraj)
    pgrad = jax.jit(jax.grad(lambda p: jaz.az_losses(p, ps, vp, vs, jtraj)[0]))(pp)
    vgrad = jax.jit(jax.grad(lambda v: jaz.az_losses(pp, ps, v, vs, jtraj)[1]))(vp)

    state = az.make_state(_net("policy", pvars), _net("value", vvars), lr=1e-3)
    pl, vl = az.az_step(state, ttraj)
    np.testing.assert_allclose([float(pl), float(vl)], [float(jpl), float(jvl)], rtol=RTOL, atol=ATOL)
    _close({n: p.grad for n, p in state.policy.named_parameters()}, _sd(pgrad), "policy gradient")
    _close({n: p.grad for n, p in state.value.named_parameters()}, _sd(vgrad), "value gradient")
    assert not state.policy.training and not state.value.training
    for net, variables in ((state.policy, pvars), (state.value, vvars)):
        _close(net.state_dict(), {k: v for k, v in convert.from_flax(variables).items() if "running" in k}, "stats")
    # the update with the JAX gradients lands where optax.adamw(1e-3) does
    fresh = az.make_state(_net("policy", pvars), _net("value", vvars), lr=1e-3)
    for net, opt, variables, grads in ((fresh.policy, fresh.policy_opt, pvars, pgrad),
                                       (fresh.value, fresh.value_opt, vvars, vgrad)):
        tx = optax.adamw(1e-3)
        upd, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
        _step_with(opt, net, _sd(grads))
        _close(dict(net.named_parameters()), _sd(optax.apply_updates(variables["params"], upd)), "update")


def test_az_train_loop_checkpoints_and_resumes_fresh_games():
    seen = []
    policy, value = nets.PolicyNet(8).eval(), nets.ValueNet(8).eval()
    timings = []
    state = az.train(3, policy, value, iters=2, batch=2, n_moves=3, n_rollouts=4, start_iter=5,
                     checkpoint_fn=lambda it, s: seen.append(it), log_fn=lambda _: None, timings=timings)
    assert seen == [6, 7] and len(timings) == 2 and state.policy is policy
    assert set(timings[0]) == {"selfplay_s", "update_s"}
    assert az.iteration_seed(3, 5) != az.iteration_seed(3, 6) == az.iteration_seed(3, 6)
    cfg = az.default_config(80)
    assert (cfg.expand_thresh, cfg.no_sim, cfg.max_nodes, cfg.noise_weight, cfg.max_turns, cfg.use_kernel) == (
        8, True, 512, 0.25, 80, False)


def _replay_onehot(states, net, max_turns):
    """Continue ``states`` with the one-hot policy to the end of the game."""
    probs = gendata.probs_fn(net)
    return po.playout(_gen(0), probs, probs, states, num_steps=max_turns + 1, max_turns=max_turns).final


@pytest.mark.parametrize("resolved", [False, True])
def test_genvals_samples_follow_the_recipe(resolved):
    """With one-hot policies every board plays the same moves up to its r,
    so each sample's r is found by matching its board against the one
    prefix: the sample is the prefix position at r plus one legal random
    move, r lies in [min_r, max_r), and (raw Tromp-Taylor labels) the label
    says whether the random move's player won the one-hot continuation."""
    net = OneHotPolicyNet(0)
    min_r, max_r, max_turns = 4, 9, 16
    batch = 12 if resolved else 24  # resolution plays 5 x batch boards for 96 plies
    samples = genvals.generate(_gen(5), net, net, batch, max_turns=max_turns, min_r=min_r, max_r=max_r,
                               resolved_labels=resolved, resolve_playouts=5)
    prefix = po.playout(_gen(0), gendata.probs_fn(net), gendata.probs_fn(net), st.new_game_batch(1, device="cpu"),
                        num_steps=max_r, max_turns=max_turns)
    assert bool(samples.ok.all())
    assert set(samples.val.tolist()) <= {0, 1}
    found = []
    for b in range(batch):
        match = []
        for r in range(min_r, max_r):
            pos = prefix.states.map(lambda x: x[r])
            mv = samples.move[b : b + 1]
            if bool(rules.legal_mask(pos)[0, mv]) and torch.equal(rules.step(pos, mv).board[0], samples.board[b]):
                match.append(r)
        assert match, b
        r = match[0]
        found.append(r)
        if not resolved:
            after = rules.step(prefix.states.map(lambda x: x[r]), samples.move[b : b + 1])
            final = _replay_onehot(after, net, max_turns)
            black_won = bool(rules.score(final)[0] > 0)
            assert int(samples.val[b]) == int(black_won == (r % 2 == 0)), (b, r)
    assert len(set(found)) >= 3  # r spreads over the range
    assert len(set(samples.move.tolist())) >= 5  # the random move is not the policy's
    rows = genvals.samples_to_rows(samples)
    assert len(rows) == batch and all(len(b) == NN for b, _, _, _ in rows)
