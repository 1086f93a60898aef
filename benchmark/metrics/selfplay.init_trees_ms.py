"""Search driver: ms a move in ``mcts.init_trees`` (fresh trees, the roots'
forward and expansion, the root noise), spanned with device syncs."""

HOOKS = ("bokego_tpu_torch.search.mcts:init_trees",)


def read(r):
    seg = r.spans
    if not seg.units or not seg.calls[HOOKS[0]]:
        return None
    return 1e3 * seg.span_s[HOOKS[0]] / seg.units
