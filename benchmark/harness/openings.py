"""Seeded moves of the plain reference, for the traffic: the GTP opponent's
replies and the openings that a self-play mix starts its games from.

A move is drawn at a temperature from the reference policy over the points
that the reference rules call legal (a pass where there is none).  An
opening is a list of such moves from the empty board, as the program's
actions; the entry plays it through the program's rules, and the check
compares the program's start position with the reference game's.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import features as ref_features
from benchmark.reference import nets as ref_nets
from benchmark.reference import rules as ref_rules

LEGAL_PLANE = 5  # the planes' legal-move plane


def choose(rng: np.random.Generator, planes: np.ndarray, probs, temperature: float) -> int:
    """A move of the position whose ``planes`` are given, drawn from
    ``probs`` (81) at ``temperature`` over its legal points."""
    legal = planes[LEGAL_PLANE].reshape(-1) > 0
    if not legal.any():
        return ref_rules.PASS
    logits = torch.log(torch.as_tensor(probs, dtype=torch.float64).cpu())
    p = torch.softmax(logits / temperature, 0).numpy() * legal
    return int(rng.choice(81, p=p / p.sum()))


def plies_of(count: int, lo: int, hi: int) -> list[int]:
    """``count`` opening lengths spread evenly over ``[lo, hi]``."""
    return [lo + (i * (hi - lo + 1)) // count for i in range(count)]


def make(count: int, lo: int, hi: int, seed: int, policy_path, temperature: float, device):
    """``count`` openings with lengths from :func:`plies_of`: ``(actions,
    games)``, each opening's actions and its reference game after them.
    The policy runs on ``device`` in float64, so that the same seed draws
    the same moves on any run."""
    plies = plies_of(count, lo, hi)
    rng = np.random.default_rng([seed, 13])
    sd = {k: v.to(device, torch.float64) for k, v in ref_nets.load(str(policy_path)).items()}
    games = [ref_rules.OracleGame() for _ in range(count)]
    actions: list[list[int]] = [[] for _ in range(count)]
    for t in range(max(plies, default=0)):
        live = [i for i in range(count) if plies[i] > t]
        planes = ref_features.batch([games[i] for i in live])
        probs = ref_nets.policy_probs(sd, torch.from_numpy(planes).to(device, torch.float64))
        for row, i in enumerate(live):
            move = choose(rng, planes[row], probs[row], temperature)
            games[i].play(move)
            actions[i].append(ref_rules.PASS_ACTION if move == ref_rules.PASS else move)
    return actions, games
