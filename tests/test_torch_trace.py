"""The program's own tracing (``utils/metrics.span``, ``count``, the
``Recorder``): off it records nothing and reads no clock; on, spans nest
with their self time and requests; tracing changes no move and no tree;
the counts are what the code implies; and every host read of a tensor on
the search's and the engine's paths sits alone inside a ``sync.<site>``
span (the card-side check with CUDA's sync debug mode is in
``tests/test_torch_cuda.py``)."""

import collections
import time

import pytest
import torch

from bokego_tpu_torch.config import EngineConfig, SearchConfig
from bokego_tpu_torch.env import rules, state as st
from bokego_tpu_torch.gtp.engine import GTPEngine
from bokego_tpu_torch.search import mcts
from bokego_tpu_torch.utils import metrics
from tests.torch_fake_eval import fake_evaluator

KERNEL_CFG = SearchConfig(
    expand_thresh=2, no_sim=True, max_turns=80, max_nodes=256, n_rollouts=24,
    eval_every=8, kernel_levels=6, use_kernel=True, noise_weight=0.25, dirichlet_alpha=0.1,
)
ENGINE_CFG = SearchConfig(expand_thresh=2, no_sim=True, max_nodes=512)


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off."""
    metrics.disable()
    yield
    metrics.disable()


def _traced(fn):
    """``fn()`` with a fresh recorder on; returns its result and the recorder."""
    with metrics.recording() as rec:
        return fn(), rec


def _roots(batch: int = 4, plies: int = 6):
    gen = torch.Generator().manual_seed(7)
    roots = st.new_game_batch(batch, device="cpu")
    for _ in range(plies):
        legal = rules.legal_mask(roots)[:, :81].float()
        roots = rules.step(roots, torch.multinomial(legal, 1, generator=gen)[:, 0])
    return roots


def _selfplay_move(roots):
    """One move of the self-play loop on the kernel path (the kernels'
    plain versions on the CPU), root noise from a seeded generator."""
    gen = torch.Generator().manual_seed(3)
    actions, trees = mcts.search(roots, fake_evaluator(), None, KERNEL_CFG, gen=gen)
    nxt = rules.step(roots, actions)
    return actions, trees, nxt, rules.is_terminal(nxt, KERNEL_CFG.max_turns)


def _engine():
    eng = GTPEngine(
        fake_evaluator(), None, ENGINE_CFG,
        EngineConfig(time_lim=None, n_rollouts=16, pondering=False), device="cpu", seed=5,
    )
    eng.running = True
    assert eng.send("play black E5").startswith("=")
    return eng


def _engine_genmove():
    eng = _engine()
    return eng.send("genmove white"), eng


def _assert_trees_equal(a, b):
    for x, y in zip(a.nodes.tensors(), b.nodes.tensors()):
        assert torch.equal(x, y)
    for f in ("parent", "action", "pstats", "root_stats", "value", "expanded", "terminal", "n_nodes", "root"):
        torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0, atol=0, equal_nan=True)


def test_span_off_is_one_shared_noop(monkeypatch):
    """Off: the same context for every name, no clock read, no
    ``record_function``, nothing counted."""
    def refuse(*a, **k):
        raise AssertionError("read while tracing is off")

    monkeypatch.setattr(time, "perf_counter_ns", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert metrics.disable() is None
    first = metrics.span("search")
    assert metrics.span("sync.group_pass", request=3) is first
    with first:
        with metrics.span("rules.step"):
            metrics.count("search.rollouts", 8)
    _, rec = _traced(lambda: None)
    assert rec.snapshot() == {"spans": {}, "counters": {}} and rec.spans == []


def test_span_nesting_self_time_and_requests(monkeypatch):
    """Spans nest; self time is a span's time less its children's; a
    request is given, numbered (``NEXT``) or taken from the enclosing span."""
    ticks = iter(range(0, 10_000, 10))
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks))
    recorder = metrics.enable()
    with metrics.span("search", request=metrics.NEXT):  # 0 .. 70
        with metrics.span("search.eval"):  # 10 .. 40
            with metrics.span("sync.any_work"):  # 20 .. 30
                pass
        with metrics.span("search.eval"):  # 50 .. 60
            metrics.count("search.rollouts", 8)
    with metrics.span("gtp.genmove", request="12"):  # 80 .. 90
        pass
    with metrics.span("search", request=metrics.NEXT):  # 100 .. 110
        pass
    assert recorder.spans == [
        ["search", 0, 70, -1, 0],
        ["search.eval", 10, 40, 0, 0],
        ["sync.any_work", 20, 30, 1, 0],
        ["search.eval", 50, 60, 0, 0],
        ["gtp.genmove", 80, 90, -1, "12"],
        ["search", 100, 110, -1, 1],
    ]
    snap = recorder.snapshot()
    assert snap["counters"] == {"search.rollouts": 8}
    s = {k: (v["count"], round(v["total_s"] * 1e9), round(v["self_s"] * 1e9)) for k, v in snap["spans"].items()}
    assert s == {
        "search": (2, 80, 80 - 40),
        "search.eval": (2, 40, 40 - 10),
        "sync.any_work": (1, 10, 10),
        "gtp.genmove": (1, 10, 10),
    }


def test_span_annotates_only_while_the_profiler_records():
    """Without a profiler no ``record_function`` opens; under one, each
    span is a ``user_annotation`` event of the trace."""
    recorder = metrics.enable()
    with metrics.span("plain"):
        torch.ones(4) + 1
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.span("search.eval"):
            with metrics.span("sync.any_work"):
                bool(torch.ones(4).any())
    metrics.disable()
    names = {e.name for e in prof.events()}
    assert {"search.eval", "sync.any_work"} <= names and "plain" not in names
    assert recorder.phases["plain"].count == recorder.phases["search.eval"].count == 1


def test_traced_selfplay_move_equals_untraced():
    """Tracing changes no action, state or tree of a batched move; the
    counts are the move's: one any-work sync per eval step, one nonzero per
    expansion, the rollouts asked for."""
    roots = _roots()
    want = _selfplay_move(roots)
    got, recorder = _traced(lambda: _selfplay_move(roots))
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    _assert_trees_equal(got[1], want[1])
    for x, y in zip(got[2].tensors(), want[2].tensors()):
        assert torch.equal(x, y)
    ph = recorder.phases
    evals = sum(e for _, e in mcts.rollout_groups(KERNEL_CFG.n_rollouts, KERNEL_CFG.eval_every))
    assert ph["search"].count == 1 and ph["search.init_trees"].count == 1
    assert ph["sync.any_work"].count == ph["search.eval"].count == evals == 3
    assert ph["search.k1"].count == len(mcts.rollout_groups(KERNEL_CFG.n_rollouts, KERNEL_CFG.eval_every))
    assert ph["sync.expand_nonzero"].count == ph["search.expand"].count == 1 + ph["search.eval_and_expand"].count
    assert ph["rules.step"].count == 1 and ph["sync.group_pass"].count >= 2
    assert recorder.counters["search.rollouts"] == KERNEL_CFG.n_rollouts
    search = recorder.spans[0]
    assert search[0] == "search" and {s[4] for s in recorder.spans if s[1] < search[2]} == {0}
    assert {s[4] for s in recorder.spans if s[1] > search[2]} == {None}


def test_traced_genmove_equals_untraced(monkeypatch):
    """Tracing changes no reply and no tree of a ``genmove``; the search
    ran the rollouts asked for, a descent-level sync per level walked, a
    work-flag sync per rollout, a pool check per chunk."""
    want, want_eng = _engine_genmove()
    levels = []
    descend = mcts._descend_batch

    def counted(trees, cfg, w):
        d = descend(trees, cfg, w)
        levels.append(min(int(d.depth.max()) + 1, cfg.max_depth - 1))
        return d

    monkeypatch.setattr(mcts, "_descend_batch", counted)
    (got, got_eng), recorder = _traced(_engine_genmove)
    assert got == want
    _assert_trees_equal(got_eng.trees, want_eng.trees)
    ph = recorder.phases
    assert recorder.counters["search.rollouts"] == 16 == len(levels) == ph["search.descend"].count
    assert ph["search.backprop"].count == ph["sync.work_flag"].count == 16
    assert ph["sync.descend_level"].count == sum(levels)
    assert ph["sync.pool_full"].count == 2 and ph["gtp.search"].count == 1
    assert ph["gtp.play"].count == ph["gtp.genmove"].count == 1 and ph["gtp.apply_move"].count == 2
    genmove = next(s for s in recorder.spans if s[0] == "gtp.genmove")
    assert all(s[4] == genmove[4] for s in recorder.spans if s[1] >= genmove[1])


def test_genmove_descends_once_a_rollout_and_launches_nothing_on_the_cpu():
    """A ``genmove`` of the engine's default search: one descent and one
    backprop a rollout, expansions, no K1; on CPU tensors the kernels'
    plain versions run and no ``ops.*`` launch is counted."""
    _, recorder = _traced(_engine_genmove)
    ph = recorder.phases
    assert recorder.counters["search.rollouts"] == 16 == ph["search.descend"].count == ph["search.backprop"].count
    assert ph["search.expand"].count > 0 and "search.k1" not in ph
    assert not [k for k in recorder.counters if k.startswith("ops.")]
    assert ph["sync.descend_level"].count >= 16


def _innermost_open(rec) -> str | None:
    open_spans = [s for s in rec.spans if s[2] == 0]
    return open_spans[-1][0] if open_spans else None


@pytest.mark.parametrize("path", ["selfplay_move", "genmove"])
def test_every_host_read_is_one_sync_span(monkeypatch, path):
    """Each way a tensor's value reaches the host (``bool``, ``int``,
    ``float``, ``item``, ``tolist``, ``nonzero``, ``torch.equal``, a host
    list sent to a device) happens inside a ``sync.<site>`` span, one read
    a span, in a batched move and in a ``genmove`` (after set-up): on a GPU
    each is a host synchronisation."""
    reads = []
    if path == "genmove":
        eng = _engine()
        run = lambda: eng.send("genmove white")  # noqa: E731
    else:
        roots = _roots()
        run = lambda: _selfplay_move(roots)  # noqa: E731

    def watch(fn):
        def read(*a, **k):
            reads.append(_innermost_open(recorder))
            return fn(*a, **k)

        return read

    for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, watch(getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch, "equal", watch(torch.equal))
    tensor = torch.tensor

    def to_device(*a, **k):
        if k.get("device") is not None:
            reads.append(_innermost_open(recorder))
        return tensor(*a, **k)

    monkeypatch.setattr(torch, "tensor", to_device)
    recorder = metrics.enable()
    try:
        run()
    finally:
        metrics.disable()
    spans = {name: c.count for name, c in recorder.phases.items() if name.startswith("sync.")}
    outside = sorted({str(r) for r in reads if not (r or "").startswith("sync.")})
    assert reads and not outside, f"host reads inside no sync span, innermost: {outside}"
    assert collections.Counter(reads) == spans
