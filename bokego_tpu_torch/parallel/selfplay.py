"""Batched MCTS self-play (counterpart of ``bokego_tpu/parallel/selfplay.py``).

A batch of B games advances in lockstep: per move, a fresh-tree search on
every game, then one batched rules step.  The JAX package scans this loop
under ``jit``; here it is a Python loop over moves.

Sharded over a data-parallel mesh (``parallel/mesh.py``), every rank plays
its B/k games with the unsharded code, the rollout kernels included, on its
own device, and the results are gathered: no game depends on another, so
the sharded run equals the unsharded one game for game, as GSPMD's
partitioned program equals the JAX package's unsharded one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bokego_tpu_torch.config import SearchConfig
from bokego_tpu_torch.coords import PASS_ACTION
from bokego_tpu_torch.env import rules, state as st
from bokego_tpu_torch.env.state import GoState
from bokego_tpu_torch.parallel import mesh as mesh_lib
from bokego_tpu_torch.search import mcts
from bokego_tpu_torch.search.tree import Tree


class SelfplayResult(NamedTuple):
    final: GoState  # (B,)
    actions: torch.Tensor  # (n_moves, B) — PASS once a game is done
    scores: torch.Tensor  # (B,) Tromp-Taylor


def selfplay(
    params,
    ev: mcts.Evaluator,
    cfg: SearchConfig,
    batch: int,
    n_moves: int,
    n_rollouts: int,
    device=None,
) -> SelfplayResult:
    """Play ``batch`` games for ``n_moves`` plies of MCTS each on ``device``
    (the GPU unless ``device="cpu"``)."""
    states = st.new_game_batch(batch, device=device)
    done = torch.zeros(batch, dtype=torch.bool, device=states.board.device)
    moves = []
    for _ in range(n_moves):
        actions, _ = mcts.search(states, ev, params, cfg, n_rollouts)
        actions = torch.where(done, PASS_ACTION, actions)
        states = rules.step(states, actions)
        done = done | rules.is_terminal(states, cfg.max_turns)
        moves.append(actions)
    actions = torch.stack(moves) if moves else torch.zeros((0, batch), dtype=torch.int64)
    return SelfplayResult(final=states, actions=actions, scores=rules.score(states))


def selfplay_sharded(
    mesh: mesh_lib.Mesh,
    params,
    ev: mcts.Evaluator,
    cfg: SearchConfig,
    batch: int,
    n_moves: int,
    n_rollouts: int,
) -> SelfplayResult:
    """``selfplay`` of a global ``batch`` with the games sharded over the
    mesh: rank r plays games ``r * B/k`` to ``(r + 1) * B/k`` on its device
    (the nets replicated from rank 0), and every rank returns the global
    result.  Equal to ``selfplay`` at the same ``batch``, game for game."""
    mesh_lib.replicate(params, mesh)
    local = selfplay(params, ev, cfg, mesh_lib.shard_size(batch, mesh), n_moves, n_rollouts, device=mesh.device)
    return SelfplayResult(
        final=mesh_lib.gather_rows(local.final, mesh),
        actions=mesh_lib.gather_rows(local.actions, mesh, dim=1),
        scores=mesh_lib.gather_rows(local.scores, mesh),
    )


def search_sharded(
    mesh: mesh_lib.Mesh,
    root_states: GoState,
    ev: mcts.Evaluator,
    params,
    cfg: SearchConfig,
    n_rollouts: int | None = None,
    gen: torch.Generator | None = None,
) -> tuple[torch.Tensor, Tree]:
    """``mcts.search`` over a global batch of roots sharded over the mesh:
    returns the global actions (on every rank) and this rank's trees.

    The root noise (``cfg.noise_weight > 0``) is drawn at the global shape
    from ``gen``, seeded alike on every rank, and each rank keeps its rows,
    so the draws are the unsharded search's.  The playouts of simulation
    mode draw per ply from ``gen`` on each rank's rows and cannot be split
    so: sharded simulation mode is a valid search, not the unsharded one's
    draws."""
    roots = mesh_lib.shard_rows(root_states, mesh)
    noise = None
    if cfg.noise_weight > 0:
        if gen is None:
            raise ValueError("noise_weight > 0 needs a torch.Generator (gen=)")
        noise = mesh_lib.draw_rows(
            lambda n: mcts.dirichlet_noise(gen, n, cfg.dirichlet_alpha, mesh.device), root_states.board.shape[0], mesh
        )
    trees = mcts.init_trees(roots, ev, params, cfg, gen=gen, noise=noise)
    n = cfg.n_rollouts if n_rollouts is None else n_rollouts
    trees = mcts.run_search(trees, ev, params, cfg, n, gen=gen)
    return mesh_lib.gather_rows(mcts.choose_action(trees), mesh), trees
