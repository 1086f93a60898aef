"""Non-kernel search: ms a rollout in ``mcts._descend_batch`` and
``mcts._backprop_batch``, spanned with device syncs."""

HOOKS = ("bokego_tpu_torch.search.mcts:_descend_batch", "bokego_tpu_torch.search.mcts:_backprop_batch")


def read(r):
    seg = r.spans
    rollouts = seg.calls[HOOKS[1]]
    if not rollouts:
        return None
    return 1e3 * sum(seg.span_s[h] for h in HOOKS) / rollouts
