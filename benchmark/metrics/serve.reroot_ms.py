"""GTP engine: ms a genmove in ``GTPEngine._apply_move`` (the ``play``
handling and the genmove's own re-root: ``rules.step``, ``advance_root``,
``compact``, ``expand_roots``, or a rebuild), spanned with device syncs."""

HOOKS = ("bokego_tpu_torch.gtp.engine:GTPEngine._apply_move",)


def read(r):
    seg = r.spans
    if not seg.units or not seg.calls[HOOKS[0]]:
        return None
    return 1e3 * seg.span_s[HOOKS[0]] / seg.units
