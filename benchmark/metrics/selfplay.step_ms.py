"""Self-play loop: host ms a move in ``rules.step`` and ``rules.is_terminal``
when the loop calls them (not inside the search), spanned with device syncs."""

HOOKS = ("bokego_tpu_torch.env.rules:step", "bokego_tpu_torch.env.rules:is_terminal")


def read(r):
    seg = r.spans
    if not seg.units or not seg.calls[HOOKS[0]]:
        return None
    return 1e3 * sum(seg.top_s[h] for h in HOOKS) / seg.units
