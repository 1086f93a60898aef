"""Leaf evaluation: ms a genmove in ``mcts._eval_and_expand`` (rules,
features, the batch-1 forward, the expansion), spanned with device syncs."""

HOOKS = ("bokego_tpu_torch.search.mcts:_eval_and_expand",)


def read(r):
    seg = r.spans
    if not seg.units or not seg.calls[HOOKS[0]]:
        return None
    return 1e3 * seg.span_s[HOOKS[0]] / seg.units
