"""Tests of the benchmark harness (bench_port/). CPU tests run anywhere; the
`cuda` ones skip without a card:

    python -m pytest bench_port/tests -q -p no:cacheprovider
    python -m pytest bench_port/tests -q -p no:cacheprovider -m cuda   # on the card
"""
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)


def small_cell(name, **traffic):
    """A cell of BENCHMARK.json with its traffic cut for a CPU run: a short
    rollout, the checked steps among the first few, the window's first
    update checked."""
    from portbench import spec

    cell = spec.Cell(spec.load_benchmark(), name)
    if cell.traffic["kind"] == "train":
        cell.traffic.update(ppo_config=dict(rollout_len=4, num_minibatches=2, ppo_epochs=2),
                            check_within=1)
    else:
        cell.traffic.update(check_within=2, check_steps=1, warm_steps=1)
    cell.traffic.update(traffic)
    return cell
