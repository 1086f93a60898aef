"""FLOPs, bytes, model-FLOP utilisation and roofline of the self-play move
on the GPU (the port's counterpart of ``tools/mfu_report.py``).

    python -m bokego_tpu_torch.mfu_report [--batch 1024] [--rollouts 400] [--eval-every 8]
        [--peak-tflops-f32 67] [--peak-tflops-tf32 495] [--peak-gbs 3350] [--device cuda]

Runs the bench configuration (``config.BENCH_CONFIG`` at ``--rollouts`` and
``--eval-every``; the bench's nets, the JAX tool's random-init
``init_policy(PRNGKey(0))`` and ``init_value(PRNGKey(1))`` read through
``bench.bench_nets``) and prints, under the card's name and power
limit, one table row for each of: the batched policy + value forward (CUDA
events), ``init_trees``, the K1 launches of a move, its eval phases split
into the net forwards and the rest (rules, features, expansion with K2),
and the whole move (synchronised host clock); then rollouts/s and
games/min/chip at 80 moves.

The JAX tool timed one light and one eval ``search_step``.  The port's
search groups rollouts: ``run_search`` launches K1 once for every run of
rollouts up to and including the next eval step (``rollout_groups``), so
its "light" row here is a move's K1 launches and its "eval" row a move's
eval phases.

Counts come from shapes and from the run, never from a device:

* FLOPs of a forward in two conventions (:func:`net_flops`): XLA's, which
  counts only the taps of a "same" convolution that land on the board
  (2·625·C² for a 3×3 layer on 9×9) and which ``tools/mfu_report.py``
  divides by, and the nominal count of ``torch.utils.flop_counter`` (2·729·C²);
* the least bytes of a forward (:func:`forward_bytes`): parameters,
  features in, probabilities and values out, each once;
* K1's needed bytes (:func:`k1_work`), from the move replayed rollout by
  rollout (one launch of R rollouts equals R launches of one, bit for bit);
* the forwards and K1 launches of a move, counted around ``mcts.run_search``
  (a wrapped evaluator, and the program's ``ops.*`` launch counters,
  recorded without spans, so that a timed move carries no span's cost) and
  printed beside the JAX tool's model, ``ceil(rollouts / E) + 1`` forwards.  The
  model counts a forward on every eval step, but an eval step on which no
  tree has work skips it (here as in the JAX package, whose ``lax.cond``
  does the same), so a move runs fewer; the totals count those it ran.

Every share is given against the fp32 peak (the port computes in fp32:
``device.fp32_only`` turns TF32 off) and the TF32 peak.  cuDNN may pick a
convolution algorithm (FFT, Winograd) that does less arithmetic than the
direct convolution it computes; where a share against the fp32 peak reads
over 100 % the report says that it is no bound there.  The convolution
kernels that ran are named from a ``torch.profiler`` pass over one forward.

With ``--device cpu`` (sizes default to the JAX tool's ``--smoke``: B=8, 16
rollouts, E=4) it prints the counts only, and "not measured" wherever a
device time or share would stand.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses

import torch

from bokego_tpu_torch import bench
from bokego_tpu_torch.bin import add_device_flag, device_from
from bokego_tpu_torch.config import BENCH_CONFIG
from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.env import rules, state as st
from bokego_tpu_torch.features import features_batch
from bokego_tpu_torch.models import nets
from bokego_tpu_torch.ops import rollout
from bokego_tpu_torch.search import mcts
from bokego_tpu_torch.utils import metrics

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # float32 outside the tensor cores
TF32_FLOPS = 495e12  # TF32 on the tensor cores
CHANNELS = 128  # the nets' width
BOARD = 9
FEATURES = 27
SIZES = {"cuda": (1024, 400, 8), "cpu": (8, 16, 4)}  # (batch, rollouts, eval_every) by device
MOVES = 3  # whole moves timed after the warm-up and the split move
FORWARD_ITERS = 10  # forwards timed with CUDA events
NOT_MEASURED = "not measured"


# ---------------------------------------------------------------------------
# Counts from shapes.


def _taps(k: int, pad: int, size: int = BOARD) -> int:
    """(output, tap) pairs along one axis of a stride-1 convolution whose
    input index lands on the board."""
    out = size + 2 * pad - k + 1
    return sum(1 for o in range(out) for t in range(k) if 0 <= o - pad + t < size)


def layer_macs(net: torch.nn.Module) -> list[tuple[str, int, int]]:
    """``(kind, valid-tap MACs, nominal MACs)`` per position for each
    convolution and linear layer of ``net``, in module order."""
    out = []
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            (kh, kw), (ph, pw) = m.kernel_size, m.padding
            oh, ow = BOARD + 2 * ph - kh + 1, BOARD + 2 * pw - kw + 1
            io = m.in_channels * m.out_channels // m.groups
            out.append(("conv", _taps(kh, ph) * _taps(kw, pw) * io, oh * ow * kh * kw * io))
        elif isinstance(m, nets.UntiedBiasConv):
            out_ch, in_ch = m.weight.shape[:2]
            out.append(("conv", NN * in_ch * out_ch, NN * in_ch * out_ch))
        elif isinstance(m, torch.nn.Linear):
            out.append(("linear", m.in_features * m.out_features, m.in_features * m.out_features))
    return out


def _meta_nets(channels: int) -> tuple[nets.PolicyNet, nets.ValueNet]:
    with torch.device("meta"):
        return nets.PolicyNet(channels), nets.ValueNet(channels)


def net_flops(channels: int, batch: int, convs_only: bool = False) -> tuple[int, int]:
    """FLOPs of one policy + value forward over ``batch`` positions:
    ``(valid taps, nominal)``.  The first counts, for each convolution, the
    taps that land on the board, as XLA's ``cost_analysis`` does (it adds
    the elementwise ops, 0.27 % at 128 channels); the second every tap of
    the padded input, as ``torch.utils.flop_counter`` does.  Linear layers
    count alike in both; ``convs_only`` leaves them out."""
    layers = [x for net in _meta_nets(channels) for x in layer_macs(net)]
    valid = sum(v for kind, v, _ in layers if kind == "conv" or not convs_only)
    nominal = sum(n for kind, _, n in layers if kind == "conv" or not convs_only)
    return 2 * valid * batch, 2 * nominal * batch


def param_bytes(channels: int) -> int:
    """Bytes of the two nets' parameters (fp32); the BatchNorm running
    statistics fold into the convolutions' scale and shift."""
    return 4 * sum(p.numel() for net in _meta_nets(channels) for p in net.parameters())


def forward_bytes(channels: int, batch: int) -> int:
    """The least bytes a policy + value forward moves: every parameter and
    every feature read once, probabilities and values written once."""
    return param_bytes(channels) + 4 * batch * (NN * FEATURES + NN + 1)


def eval_model(rollouts: int, eval_every: int) -> int:
    """The forwards of a move in the JAX tool's model: one per eval step
    and the roots' forward in ``init_trees``."""
    return -(-rollouts // eval_every) + 1


def bound_ms(
    n_bytes: float, n_ops: float, peak_ops: float = FP32_FLOPS, peak_bytes: float = HBM_BYTES_PER_S
) -> tuple[float, str]:
    """The least time (ms) for ``n_bytes`` and ``n_ops``: the larger of
    bytes over the memory rate and operations over the peak rate, and which
    of the two it is."""
    t_bytes, t_ops = n_bytes / peak_bytes, n_ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def k1_work(results, parent, levels: int, planes: int) -> tuple[int, int]:
    """Bytes and operations that the rollouts described by ``results`` (one
    kernel ``res`` per rollout, all from one call) need: every stats row
    walked through read once (81 actions of ``planes`` planes; the child
    plane alone for a leaf's row, read to find it childless), every updated
    edge written once (N, Wv), every leaf value read once, and per tree the
    root, the root stats in and out, one child-terminal float and the result
    row.  The paths are rebuilt from the leaves through ``parent``."""
    batch = parent.shape[0]
    ar = torch.arange(batch, device=parent.device)
    inner = torch.zeros_like(parent, dtype=torch.bool)
    leaf_rows, edges, leaves = inner.clone(), inner.clone(), inner.clone()
    walked = 0
    for res in results:
        kd = rollout.unpack(res)
        node, left = kd.leaf, kd.depth.clone()
        leaves[ar, node] = True
        early = kd.depth < levels
        leaf_rows[ar[early], node[early]] = True
        walked += int(kd.depth.sum())
        for _ in range(levels):
            on = left > 0
            edges[ar[on], node[on]] = True
            node = torch.where(on, parent[ar, node], node)
            inner[ar[on], node[on]] = True
            left -= 1
    n_bytes = (
        int(inner.sum()) * 81 * planes * 4 + int((leaf_rows & ~inner).sum()) * 81 * 4
        + int(edges.sum()) * 8 + int(leaves.sum()) * 4 + batch * (8 + 12 + 12 + 4 + 512)
    )
    return n_bytes, walked * 81 * 12


# ---------------------------------------------------------------------------
# Counts from a run.


@dataclasses.dataclass
class MoveCounts:
    """What one move ran: the batch of each net forward, and the program's
    counters (``utils/metrics``), among them each kernel's launches as
    ``ops.<wrapper>`` and K1's rollouts as ``ops.descend_backprop.rollouts``
    (none on the CPU, where the plain versions run)."""

    forwards: list[int] = dataclasses.field(default_factory=list)
    counters: dict[str, float] = dataclasses.field(default_factory=dict)


@contextlib.contextmanager
def counting(ev: mcts.Evaluator):
    """While open, the forwards of the yielded evaluator are counted into
    the yielded ``MoveCounts``, and the program's counts (not its spans)
    into its ``counters``."""
    counts = MoveCounts()

    def evaluate(params, states):
        counts.forwards.append(int(states.board.shape[0]))
        return ev.evaluate(params, states)

    def evaluate_fts(params, fts):
        counts.forwards.append(int(fts.shape[0]))
        return ev.evaluate_fts(params, fts)

    with metrics.recording(spans=False) as rec:
        counts.counters = rec.counters
        yield ev._replace(evaluate=evaluate, evaluate_fts=evaluate_fts if ev.evaluate_fts else None), counts


def search_move(states, ev, params, cfg):
    """One self-play move: a fresh-tree search, then the rules' step."""
    trees = mcts.init_trees(states, ev, params, cfg)
    trees = mcts.run_search(trees, ev, params, cfg, cfg.n_rollouts)
    return rules.step(states, mcts.choose_action(trees))


def k1_move_work(states, ev, params, cfg) -> tuple[int, int, object]:
    """K1's needed bytes and operations over the launches of the move from
    ``states``, and the searched trees: the move replayed group by group
    with one rollout a call, each group's rollouts counted as one launch's."""
    trees = mcts.init_trees(states, ev, params, cfg)
    n_bytes = n_ops = 0
    for length, evaluate in mcts.rollout_groups(cfg.n_rollouts, cfg.eval_every):
        results = [mcts.launch_rollouts(trees, ev, cfg, 1) for _ in range(length)]
        b, o = k1_work(results, trees.parent, cfg.kernel_levels, planes=4)  # w=1: four planes
        n_bytes, n_ops = n_bytes + b, n_ops + o
        if evaluate:
            trees = mcts.evaluate_leaves(trees, ev, params, cfg, results[-1])
    return n_bytes, n_ops, trees


# ---------------------------------------------------------------------------
# Times on the card.


def forward_ms(ev, params, fts, iters: int = FORWARD_ITERS) -> float:
    """Device time (ms) of one batched forward, CUDA events over ``iters``."""
    ev.evaluate_fts(params, fts)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        ev.evaluate_fts(params, fts)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def forward_kernels(forward) -> list[tuple[str, str, float]]:
    """``(launching op, kernel, device ms)`` of every kernel of one call of
    ``forward`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    return [(e.name, k.name, k.duration / 1e3) for e in prof.events() for k in e.kernels]


def nominal_flops_counted(forward) -> int:
    """FLOPs of one call of ``forward`` by ``torch.utils.flop_counter``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        forward()
    return fc.get_total_flops()


# ---------------------------------------------------------------------------
# The report.


@dataclasses.dataclass(frozen=True)
class Peaks:
    fp32: float = FP32_FLOPS
    tf32: float = TF32_FLOPS
    hbm: float = HBM_BYTES_PER_S


def _pct(x: float) -> str:
    return f"{100 * x:.1f}%"


def row(name: str, flops: tuple[int, int] | None, n_bytes: int | None, ms: float | None, peaks: Peaks) -> str:
    """One table row; ``None`` for what was not counted or not measured."""
    gflop = "not counted" if flops is None else f"{flops[0] / 1e9:.2f} / {flops[1] / 1e9:.2f}"
    mb = "not counted" if n_bytes is None else f"{n_bytes / 1e6:.2f}"
    if flops is None or n_bytes is None:
        bound = "not counted"
    else:
        b_ms, b_by = bound_ms(n_bytes, flops[0], peaks.fp32, peaks.hbm)
        bound = f"{'compute' if b_by == 'operations' else 'memory'} ({b_ms:.3f} ms at fp32)"
    if ms is None:
        t = f32 = t32 = hbm = NOT_MEASURED
    else:
        t, s = f"{ms:.2f}", ms / 1e3
        f32 = t32 = "not counted"
        if flops is not None:
            f32 = f"{_pct(flops[0] / s / peaks.fp32)} / {_pct(flops[1] / s / peaks.fp32)}"
            t32 = f"{_pct(flops[0] / s / peaks.tf32)} / {_pct(flops[1] / s / peaks.tf32)}"
        hbm = "not counted" if n_bytes is None else _pct(n_bytes / s / peaks.hbm)
    return f"| {name} | {gflop} | {mb} | {t} | {f32} | {t32} | {hbm} | {bound} |"


HEADER = (
    "| phase | GFLOP (valid taps / nominal) | MB needed | ms | share of fp32 peak (valid / nominal) "
    "| share of TF32 peak (valid / nominal) | %HBM roof | bound |\n|---|---|---|---|---|---|---|---|"
)


def _over_fp32(name: str, flops: tuple[int, int], ms: float | None, peaks: Peaks) -> str | None:
    if ms is not None and flops[0] / (ms / 1e3) > peaks.fp32:
        return (
            f"note: {name} reads over 100% of the fp32 peak: its algorithm does less arithmetic than the direct "
            "convolution it computes, so that share is no bound there"
        )
    return None


def _fwd_totals(batches: list[int]) -> tuple[tuple[int, int], int]:
    """FLOPs (valid taps, nominal) and least bytes of forwards at ``batches``."""
    per = [net_flops(CHANNELS, b) for b in batches]
    return (sum(f[0] for f in per), sum(f[1] for f in per)), sum(forward_bytes(CHANNELS, b) for b in batches)


def report(dev, batch: int, rollouts: int, eval_every: int, peaks: Peaks = Peaks(), moves: int = MOVES) -> dict:
    """Run and print the report; returns its counts and times.  On the card:
    a warm-up move (cuDNN's set-up), a move split by phase, ``moves`` timed
    moves, the forward timed and profiled; on the CPU one move, counted."""
    from bokego_tpu_torch import measure

    on_card = dev.type == "cuda"
    cfg = dataclasses.replace(BENCH_CONFIG, n_rollouts=rollouts, eval_every=eval_every)
    params, ev = bench.bench_nets(dev, "fp32")
    model = eval_model(rollouts, eval_every)
    groups = mcts.rollout_groups(rollouts, eval_every)
    if on_card:
        print(measure.card_line())
        print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__} cuda {torch.version.cuda}")
    else:
        print("device cpu: counts only; every device time and share is not measured")
    print(
        f"batch={batch} rollouts={rollouts} eval_every={eval_every} channels={CHANNELS} "
        f"peaks: {peaks.fp32 / 1e12:g} TFLOP/s fp32, {peaks.tf32 / 1e12:g} TFLOP/s TF32, {peaks.hbm / 1e9:g} GB/s"
    )

    # The moves: the split move's phases, the timed moves' totals.
    states = st.new_game_batch(batch, device=dev)
    split, move_ms, counted = None, [], []
    if on_card:
        states = search_move(states, ev, params, cfg)  # warm-up
        split_states = states
        with counting(ev) as (cev, split_counts):
            split, states = measure.group_split(states, params, cev, cfg)
        for _ in range(moves):
            with counting(ev) as (cev, counts):
                states, dt = measure._sync_time(lambda: search_move(states, cev, params, cfg))
            move_ms.append(dt * 1e3)
            counted.append(counts)
    else:  # nothing launches on the CPU: the move's spans give K1's calls
        split_states = states
        with metrics.recording() as traced, counting(ev) as (cev, split_counts):
            states = search_move(states, cev, params, cfg)
        counted.append(split_counts)

    def k1_calls(c: MoveCounts) -> tuple[int, int]:
        """K1's calls and their rollouts in a counted move."""
        if on_card:
            return int(c.counters["ops.descend_backprop"]), int(c.counters["ops.descend_backprop.rollouts"])
        return traced.phases["search.k1"].count, int(traced.counters["search.rollouts"])

    k1_bytes, k1_ops, _ = k1_move_work(split_states, ev, params, cfg)

    f_net, b_net = net_flops(CHANNELS, batch), forward_bytes(CHANNELS, batch)
    n_eval = len(split_counts.forwards) - 1  # the first forward is init_trees'
    eval_flops, eval_bytes = _fwd_totals(split_counts.forwards[1:])
    move_fwd_flops, move_fwd_bytes = _fwd_totals(counted[0].forwards)
    move_flops = (move_fwd_flops[0] + k1_ops, move_fwd_flops[1] + k1_ops)
    move_bytes = move_fwd_bytes + k1_bytes
    conv_flops = net_flops(CHANNELS, batch, convs_only=True)

    # The forward alone, on the card.
    fts = features_batch(states)
    t_net = conv_ms = nominal = None
    conv = []
    if on_card:
        t_net = forward_ms(ev, params, fts)
        kernels = forward_kernels(lambda: ev.evaluate_fts(params, fts))
        conv = [(k, ms) for op, k, ms in kernels if "convolution" in op]
        if not conv:
            raise RuntimeError(f"no convolution kernel in the profiled forward: {sorted({op for op, _, _ in kernels})}")
        conv_ms = sum(ms for _, ms in conv)
        nominal = nominal_flops_counted(lambda: ev.evaluate_fts(params, fts))

    t_init = t_k1 = t_eval = t_move = t_fwds = t_rest = None
    if on_card:
        t_init, t_eval = split["init_trees"], split["eval phases"]
        t_k1 = next(v for k, v in split.items() if k.startswith("K1 launches"))
        t_move = sum(move_ms) / len(move_ms)
        t_fwds = n_eval * t_net
        t_rest = t_eval - t_fwds
    k1_what = "launches" if on_card else "calls"
    n_phases = sum(evaluate for _, evaluate in groups)
    rows = [
        (f"net forward (policy+value, B={batch}; CUDA events)", f_net, b_net, t_net),
        ("init_trees (roots' forward, expansion with K2)", f_net, b_net, t_init),
        (f"K1 {k1_what} ({'%d for %d' % k1_calls(split_counts)} rollouts)", (k1_ops, k1_ops), k1_bytes, t_k1),
        (f"eval phases ({n_phases}; {n_eval} ran a forward)", eval_flops, eval_bytes, t_eval),
        (f"  of which {n_eval} net forwards ({n_eval} x the forward's time)", eval_flops, eval_bytes, t_fwds),
        ("  of which the rest (rules, features, expansion with K2)", None, None, t_rest),
        (f"full move ({rollouts} rollouts + choose + step, executed totals)", move_flops, move_bytes, t_move),
    ]
    print()
    print(HEADER)
    for r in rows:
        print(row(*r, peaks))
    notes = [_over_fp32(name, f, t, peaks) for name, f, _, t in rows if f is not None]
    print()
    for what, c in [("split move", split_counts)] * on_card + [("move", c) for c in counted]:
        print(
            f"{what}: forwards {len(c.forwards)} at batches {sorted(set(c.forwards))} (the JAX tool's model "
            f"ceil({rollouts}/{eval_every})+1 = {model}); K1 calls {'%d running %d' % k1_calls(c)} rollouts "
            f"(rollout_groups: {len(groups)}); K2 launches {c.counters['ops.write_rows']:g}"
            + ("" if on_card else " (the plain versions on the CPU: no launch)")
        )
    if any(len(c.forwards) < model for c in [split_counts, *counted]):
        print(
            f"note: the JAX tool's model counts a forward on each of the {model - 1} eval steps and init_trees; an "
            "eval step on which no tree has work skips its forward (as the JAX package's lax.cond does), so the "
            "FLOP and byte totals above count the forwards that ran"
        )
    if on_card:
        by_name: dict[str, list[float]] = {}
        for k, ms in conv:
            by_name.setdefault(k, []).append(ms)
        print(f"convolution kernels of one forward ({len(conv)} launches, {len(by_name)} kernels):")
        for k, times in sorted(by_name.items(), key=lambda kv: -sum(kv[1])):
            print(f"  {sum(times):9.3f} ms  {len(times):3d} calls  {k[:110]}")
        rate = conv_flops[0] / (conv_ms / 1e3)
        print(
            f"convolutions: {conv_flops[0] / 1e9:.2f} / {conv_flops[1] / 1e9:.2f} GFLOP (valid taps / nominal) in "
            f"{conv_ms:.3f} ms of kernel time: {rate / 1e12:.1f} / {conv_flops[1] / (conv_ms / 1e3) / 1e12:.1f} "
            f"TFLOP/s, {_pct(rate / peaks.fp32)} of the fp32 peak, {_pct(rate / peaks.tf32)} of the TF32 peak; "
            f"the whole forward's kernels {sum(ms for _, _, ms in kernels):.3f} ms"
        )
        notes.append(_over_fp32("the convolution kernels", conv_flops, conv_ms, peaks))
        print(f"nominal FLOPs of one forward by torch.utils.flop_counter: {nominal}")
        print(f"whole moves (ms): {', '.join(f'{t:.2f}' for t in move_ms)}")
        print(
            f"rollouts/s (batched): {batch * rollouts / (t_move / 1e3):,.0f}; move latency {t_move / 1e3:.3f}s; "
            f"games/min/chip at 80 moves ~= {batch * 60 / (t_move / 1e3 * 80):,.1f}"
        )
    else:
        print(f"convolutions: {conv_flops[0] / 1e9:.2f} / {conv_flops[1] / 1e9:.2f} GFLOP (valid taps / nominal); "
              f"kernel time {NOT_MEASURED}")
        print(f"rollouts/s (batched): {NOT_MEASURED}; move latency {NOT_MEASURED}; games/min/chip {NOT_MEASURED}")
    for n in notes:
        if n:
            print(n)
    return dict(
        model_forwards=model, counts=counted, split_counts=split_counts, split=split, move_ms=move_ms,
        net_flops=f_net, nominal_flops_counted=nominal, move_flops=move_flops, k1_bytes=k1_bytes, k1_ops=k1_ops,
        forward_ms=t_net, conv_ms=conv_ms, kernels=sorted({k for k, _ in conv}),
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=None, help="games (default 1024; 8 with --device cpu)")
    p.add_argument("--rollouts", type=int, default=None, help="rollouts a move (default 400; 16 on the CPU)")
    p.add_argument("--eval-every", type=int, default=None, help="eval cadence E (default 8; 4 on the CPU)")
    p.add_argument("--peak-tflops-f32", type=float, default=FP32_FLOPS / 1e12)
    p.add_argument("--peak-tflops-tf32", type=float, default=TF32_FLOPS / 1e12)
    p.add_argument("--peak-gbs", type=float, default=HBM_BYTES_PER_S / 1e9)
    add_device_flag(p)
    args = p.parse_args(argv)
    dev = device_from(args)
    sizes = SIZES["cuda" if dev.type == "cuda" else "cpu"]
    batch, rollouts, eval_every = (
        given if given is not None else default
        for given, default in zip((args.batch, args.rollouts, args.eval_every), sizes)
    )
    peaks = Peaks(args.peak_tflops_f32 * 1e12, args.peak_tflops_tf32 * 1e12, args.peak_gbs * 1e9)
    report(dev, batch, rollouts, eval_every, peaks)


if __name__ == "__main__":
    main()
