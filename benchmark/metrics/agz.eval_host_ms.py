"""Eval phase: ms a move in ``mcts.evaluate_leaves`` with the joint net's
own forwards (``inference.policy_value``) taken out: the any-work sync,
rules, features, expansion and the K2 launches."""

EVAL = "bokego_tpu_torch.search.mcts:evaluate_leaves"
NET = "bokego_tpu_torch.models.inference:policy_value"
HOOKS = (EVAL, NET)


def read(r):
    seg = r.spans
    if not seg.units or not seg.calls[EVAL]:
        return None
    return 1e3 * (seg.span_s[EVAL] - seg.inside_s[(EVAL, NET)]) / seg.units
