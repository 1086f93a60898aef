"""Eval phase: ms a move in ``mcts.evaluate_leaves`` with the nets' own
forwards (``inference.policy_probs``, ``inference.value_fn``) taken out:
the any-work sync, rules, features, expansion and the K2 launches."""

EVAL = "bokego_tpu_torch.search.mcts:evaluate_leaves"
NETS = ("bokego_tpu_torch.models.inference:policy_probs", "bokego_tpu_torch.models.inference:value_fn")
HOOKS = (EVAL,) + NETS


def read(r):
    seg = r.spans
    if not seg.units or not seg.calls[EVAL]:
        return None
    host = seg.span_s[EVAL] - sum(seg.inside_s[(EVAL, n)] for n in NETS)
    return 1e3 * host / seg.units
