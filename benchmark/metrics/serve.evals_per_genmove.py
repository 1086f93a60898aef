"""Leaf evaluation: calls of ``mcts._eval_and_expand`` a genmove in the
measured window, counted without a sync."""

HOOKS = ("bokego_tpu_torch.search.mcts:_eval_and_expand",)


def read(r):
    seg = r.window
    if not seg.units or not seg.calls[HOOKS[0]]:
        return None
    return seg.calls[HOOKS[0]] / seg.units
