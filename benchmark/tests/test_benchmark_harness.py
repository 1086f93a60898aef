"""The benchmark's harness on the CPU at a tiny size (B=4, 8 rollouts, 2 s):
the result line of both cells, the reference against itself and the port,
faults planted in the timed path that the check must refuse, a hook whose
function is gone, a cell added from new files alone, and the runs that must
exit without a result."""

from __future__ import annotations

import ast
import json
import sys

import numpy as np
import pytest
import torch

from benchmark.tests.conftest import CELLS, ROOT, SEED, TINY, last_line, run_cli, run_here

FORBIDDEN = {"jax", "jaxlib", "flax", "bokego_tpu"}


def _expected_metrics(cell: str, trace: int) -> set[str]:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if trace == 0:
        return {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    # a CPU run has no device trace: those metrics read nothing and are left out
    return {m["name"] for m in bench["per_layer"] if cell in m["workloads"] and m["source"] != "device_trace"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_a_valid_last_line(cell, trace):
    rc, out, err = run_cli(["--workload", cell, "--seed", str(SEED), "--trace", str(trace), *TINY])
    assert rc == 0, err[-3000:]
    line = last_line(out)
    assert list(line)[-1] == "check"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True, line["check"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == _expected_metrics(cell, trace)
    for m in line["metrics"].values():
        assert isinstance(m["value"], float) and m["value"] > 0 and m["unit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    # every number compared is on standard error too, as its last lines
    tail = err.strip().splitlines()[-len(line["check"]) - 1 :]
    assert [t.split()[1] for t in tail[:-1]] == list(line["check"])


def test_nothing_loads_jax_or_the_jax_package():
    code = (
        "import sys, json; sys.path.insert(0, '.'); from benchmark import run; "
        f"rc = run.main({['--workload', CELLS[1], '--seed', str(SEED), *TINY]!r}); "
        "print(json.dumps([rc, sorted({m.split('.')[0] for m in sys.modules})]))"
    )
    import subprocess

    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    rc, names = json.loads(p.stdout.strip().splitlines()[-1])
    assert rc == 0
    assert "bokego_tpu_torch" in names
    assert not FORBIDDEN & set(names)


def test_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "benchmark" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN | {"bokego_tpu_torch"}, (path.name, name)


def _short_game(seed: int, plies: int = 40):
    """A seeded game of random legal moves with a pass now and then, as
    (moves, reference games after each ply)."""
    from benchmark.reference import rules as R

    rng = np.random.default_rng(seed)
    g, moves, games = R.OracleGame(), [], []
    for t in range(plies):
        legal = sorted(g.legal_moves())
        mv = int(rng.choice(legal)) if legal and t % 13 != 12 else R.PASS
        g.play(mv)
        moves.append(mv)
        games.append(g.copy())
    return moves, games


def test_reference_agrees_with_itself_and_the_port_on_a_short_game():
    sys.path.insert(0, str(ROOT / "tests"))
    import oracle

    from benchmark.reference import features as RF
    from benchmark.reference import nets as RN
    from benchmark.reference import rules as R
    from bokego_tpu_torch.env import rules, state as st
    from bokego_tpu_torch.features import features_batch
    from bokego_tpu_torch.models import nets
    from bokego_tpu_torch.search import mcts

    moves, games = _short_game(5)
    # the frozen rules against the repository's oracle, and against the port's rules
    o, s, states = oracle.OracleGame(), st.new_game(device="cpu"), []
    for mv, g in zip(moves, games):
        o.play(mv)
        s = rules.step(s, torch.tensor([R.PASS_ACTION if mv == R.PASS else mv]))
        states.append(s)
        assert (o.board, o.ko, o.turn, o.last_move) == (g.board, g.ko, g.turn, g.last_move)
        fields = (s.board[0].tolist(), int(s.ko[0]), int(s.turn[0]), int(s.last_move[0]))
        ref = R.game_from_fields(*fields)
        assert (ref.board, ref.ko, ref.turn, ref.last_move) == (g.board, g.ko, g.turn, g.last_move)
        assert bool(rules.is_terminal(s, 80)[0]) == R.is_terminal(g, 80)
    # the planes: one by one equal to the batch, and equal to the port's
    ref = RF.batch(games)
    assert np.array_equal(ref[7], RF.planes(games[7]))
    batch = st.GoState(*[torch.cat(x) for x in zip(*[q.tensors() for q in states])])
    port = features_batch(batch).permute(0, 3, 1, 2).numpy()
    assert np.array_equal(port, ref)
    # the forward: blocks of any size agree, and agree with the port's nets on the CPU
    psd, vsd = RN.load(str(ROOT / "data/weights/policy_17.pt")), RN.load(str(ROOT / "data/weights/value_r2.pt"))
    p1, v1 = RN.forward(psd, vsd, ref)
    p2, v2 = RN.forward(psd, vsd, ref, block=7)
    assert torch.allclose(p1, p2, atol=1e-6, rtol=0) and torch.allclose(v1, v2, atol=1e-6, rtol=0)
    params = {
        "policy": nets.load_policy(str(ROOT / "data/weights/policy_17.pt"), "cpu"),
        "value": nets.load_value(str(ROOT / "data/weights/value_r2.pt"), "cpu"),
    }
    pp, vv = mcts.net_evaluator().evaluate(params, batch)
    assert (pp - p1).abs().max() < 1e-5 and (vv - v1).abs().max() < 1e-5


# -- faults in the timed path: each must turn `correct` false -----------------


def _perturb_probs(monkeypatch):
    from bokego_tpu_torch.models import inference

    plain = inference.policy_probs

    def policy_probs(net, fts, dtype=None):
        out = plain(net, fts, dtype).clone()
        out[:, 0] += 1e-3
        return out

    monkeypatch.setattr(inference, "policy_probs", policy_probs)


def _step_unchanged(monkeypatch):
    from bokego_tpu_torch.env import rules

    monkeypatch.setattr(rules, "step", lambda state, action: state)


def _half_batch(monkeypatch):
    from bokego_tpu_torch.models import inference

    for name in ("policy_probs", "value_fn"):
        plain = getattr(inference, name)

        def half(net, fts, dtype=None, plain=plain):
            keep = max(1, fts.shape[0] // 2)
            out = plain(net, fts[:keep], dtype)
            rest = out.mean(0, keepdim=True).expand((fts.shape[0] - keep,) + out.shape[1:])
            return torch.cat([out, rest])

        monkeypatch.setattr(inference, name, half)


def _alter_answer_selfplay(monkeypatch):
    from bokego_tpu_torch.search import mcts

    plain = mcts.choose_action
    monkeypatch.setattr(mcts, "choose_action", lambda trees: torch.where(plain(trees) < 80, plain(trees) + 1, plain(trees)))


def _alter_answer_gtp(monkeypatch):
    from bokego_tpu_torch.gtp import engine

    plain = engine.from_action
    monkeypatch.setattr(engine, "from_action", lambda a: plain(a + 1 if 0 <= a < 80 else a))


FAULTS = [
    (CELLS[0], _perturb_probs),
    (CELLS[0], _step_unchanged),
    (CELLS[0], _half_batch),
    (CELLS[0], _alter_answer_selfplay),
    (CELLS[1], _perturb_probs),
    (CELLS[1], _step_unchanged),
    (CELLS[1], _alter_answer_gtp),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c.split('.')[0]}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_a_fault_in_the_timed_path_turns_correct_false(cell, fault, monkeypatch, capsys):
    fault(monkeypatch)
    rc, line = run_here(capsys, ["--workload", cell, "--seed", str(SEED), *TINY])
    assert rc == 0 and line is not None
    assert line["correct"] is False, line["check"]


def test_sound_run_in_process_is_correct(capsys):
    rc, line = run_here(capsys, ["--workload", CELLS[0], "--seed", str(SEED + 1), *TINY])
    assert rc == 0 and line["correct"] is True, line["check"]


# -- the harness is driven by files ---------------------------------------------


def test_a_missing_hook_leaves_its_metric_out_and_the_run_goes_on(bench_copy):
    (bench_copy / "benchmark/metrics/selfplay.gone_ms.py").write_text(
        'HOOKS = ("bokego_tpu_torch.search.mcts:no_such_function",)\n\n\n'
        "def read(r):\n    return 1.0\n"
    )
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "selfplay.gone_ms", "unit": "ms/move", "better": "lower", "source": "program_span",
        "layer": "search driver", "moves": "selfplay_moves_per_s", "workloads": [CELLS[0]],
    })
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, out, err = run_cli(["--workload", CELLS[0], "--seed", str(SEED), "--trace", "1", *TINY], cwd=bench_copy)
    assert rc == 0, err[-3000:]
    line = last_line(out)
    assert "selfplay.gone_ms" not in line["metrics"] and "selfplay.gone_ms" in line["missing"]
    assert "selfplay.forwards_per_move" in line["metrics"]


def test_a_cell_is_added_from_new_files_alone(bench_copy):
    before = {p: p.read_bytes() for p in (bench_copy / "benchmark").rglob("*") if p.is_file()}
    conf = json.loads((bench_copy / "benchmark/configs/selfplay-b1024.json").read_text())
    conf["batch"], conf["search"]["n_rollouts"] = 6, 16
    # a new kind of entry is a new file too, found by the configuration's "entry"
    conf["entry"] = "selfplay_again"
    (bench_copy / "benchmark/entries/selfplay_again.py").write_text("from benchmark.entries.selfplay import Entry  # noqa: F401\n")
    (bench_copy / "benchmark/configs/selfplay-b6.json").write_text(json.dumps(conf))
    traffic = json.loads((bench_copy / "benchmark/traffic/newgames.json").read_text())
    traffic["moves_per_game"], traffic["kind"] = 5, "selfplay_again"
    (bench_copy / "benchmark/traffic/shortgames.json").write_text(json.dumps(traffic))
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="selfplay-b6", file="benchmark/configs/selfplay-b6.json"))
    bench["workloads"].append({"name": "selfplay-b6.shortgames", "config": "selfplay-b6", "traffic": "shortgames", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELLS[0] in m.get("workloads", []):
            m["workloads"].append("selfplay-b6.shortgames")
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, out, err = run_cli(
        ["--workload", "selfplay-b6.shortgames", "--seed", str(SEED), "--seconds", "2", "--device", "cpu"], cwd=bench_copy
    )
    assert rc == 0, err[-3000:]
    line = last_line(out)
    assert line["correct"] is True and "selfplay_moves_per_s" in line["metrics"]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_without_a_cuda_device_it_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, out, err = run_cli(["--workload", CELLS[0], "--seed", str(SEED), "--seconds", "1"])
    assert rc != 0 and out == "" and "CUDA" in err


def test_in_a_directory_of_the_benchmark_alone_it_exits_without_a_result(bench_copy, tmp_path_factory):
    bare = tmp_path_factory.mktemp("bare")
    (bare / "BENCHMARK.json").write_bytes((bench_copy / "BENCHMARK.json").read_bytes())
    import shutil

    shutil.copytree(bench_copy / "benchmark", bare / "benchmark")
    rc, out, _ = run_cli(["--workload", CELLS[0], "--seed", str(SEED), *TINY], cwd=bare)
    assert rc != 0 and out == ""


# -- requests that fail, leaves that are wrong, mixes added as data -------------


def _genmove_errors(monkeypatch):
    """Every third genmove answered at once with an error."""
    from bokego_tpu_torch.gtp.engine import GTPEngine

    plain, calls = GTPEngine._cmd_genmove, [0]

    def _cmd_genmove(self, args, resign=None):
        calls[0] += 1
        return (False, "no move") if calls[0] % 3 == 0 else plain(self, args, resign)

    monkeypatch.setattr(GTPEngine, "_cmd_genmove", _cmd_genmove)


def _genmove_raises(monkeypatch):
    """Every third genmove raises."""
    from bokego_tpu_torch.gtp.engine import GTPEngine

    plain, calls = GTPEngine.genmove, [0]

    def genmove(self, *a, **k):
        calls[0] += 1
        if calls[0] % 3 == 0:
            raise RuntimeError("planted")
        return plain(self, *a, **k)

    monkeypatch.setattr(GTPEngine, "genmove", genmove)


@pytest.mark.parametrize("fault", [_genmove_errors, _genmove_raises], ids=["error-reply", "raises"])
def test_failed_genmoves_are_counted_and_turn_correct_false(fault, monkeypatch, capsys):
    fault(monkeypatch)
    rc, line = run_here(capsys, ["--workload", CELLS[1], "--seed", str(SEED), *TINY])
    assert rc == 0 and line is not None
    assert line["correct"] is False, line["check"]
    assert line["check"]["failed_requests"]["value"] > 0
    assert line["failed"] > 0 and line["attempted"] > line["failed"]


def _wrong_successors(monkeypatch):
    """Every successor that the search's expansions make (``leaf_analysis``
    and ``child_states``) names the wrong last move: the leaves' positions
    are no longer their parents' moves, though the features and the forward
    agree with those positions."""
    from bokego_tpu_torch.env import rules

    def wrong(children):
        moved = children.last_move.clone()
        moved[:, :81] = (moved[:, :81] + 1) % 81
        return type(children)(*(moved if x is children.last_move else x for x in children.tensors()))

    plain_la, plain_cs = rules.leaf_analysis, rules.child_states

    def leaf_analysis(state):
        la = plain_la(state)
        return la._replace(children=wrong(la.children))

    def child_states(state, with_hash=True):
        children, legal = plain_cs(state, with_hash)
        return wrong(children), legal

    monkeypatch.setattr(rules, "leaf_analysis", leaf_analysis)
    monkeypatch.setattr(rules, "child_states", child_states)


@pytest.mark.parametrize("cell", CELLS)
def test_a_wrong_leaf_successor_turns_correct_false(cell, monkeypatch, capsys):
    _wrong_successors(monkeypatch)
    rc, line = run_here(capsys, ["--workload", cell, "--seed", str(SEED), *TINY])
    assert rc == 0 and line is not None
    assert line["correct"] is False, line["check"]
    assert line["check"]["leaf_successor_errors"]["value"] > 0


_FIRST_TURNS = (
    "import json, sys; sys.path.insert(0, '.'); "
    "from bokego_tpu_torch.search import mcts; plain = mcts.search; turns = []; "
    "mcts.search = lambda states, *a, **k: (turns.append(states.turn.tolist()), plain(states, *a, **k))[1]; "
    "from benchmark import run; rc = run.main(sys.argv[1:]); "
    "print(json.dumps({'rc': rc, 'turns': turns[:3]}), file=sys.stderr)"
)


@pytest.mark.parametrize(
    "mix,expect_first",
    [
        ({"start_plies": [6, 6], "openings": 2}, [6, 6, 6, 6]),
        ({"start_plies": [0, 7], "openings": 4, "restart": "slot"}, [0, 2, 4, 6]),
    ],
    ids=["ply-offset", "staggered"],
)
def test_a_mix_with_openings_is_added_from_new_files_alone(bench_copy, mix, expect_first):
    import subprocess

    before = {p: p.read_bytes() for p in (bench_copy / "benchmark").rglob("*") if p.is_file()}
    traffic = dict(json.loads((bench_copy / "benchmark/traffic/newgames.json").read_text()), **mix)
    (bench_copy / "benchmark/traffic/openings.json").write_text(json.dumps(traffic))
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "selfplay-b1024.openings", "config": "selfplay-b1024", "traffic": "openings", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELLS[0] in m.get("workloads", []):
            m["workloads"].append("selfplay-b1024.openings")
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(bench))
    p = subprocess.run(
        [sys.executable, "-c", _FIRST_TURNS, "--workload", "selfplay-b1024.openings", "--seed", str(SEED), *TINY],
        cwd=bench_copy, capture_output=True, text=True, timeout=300,
    )
    line = last_line(p.stdout)
    seen = json.loads(p.stderr.strip().splitlines()[-1])
    assert seen["rc"] == 0, p.stderr[-3000:]
    assert line["correct"] is True, line["check"]
    assert line["check"]["opening_errors"]["value"] == 0
    assert seen["turns"][0] == expect_first  # the warm-up move starts from the openings
    assert all(p.read_bytes() == b for p, b in before.items())
