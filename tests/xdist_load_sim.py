"""Replay the CPU suite's ``-n 6 --dist load`` schedule from measured test
durations, to see what a change to the port's tests does to the suite's
wall time and to the number of passes inside the time cap.

pytest-xdist's ``load`` scheduler (``xdist/scheduler/load.py``) hands each
worker a first chunk of consecutive items, then refills a worker whose
queue fell below a quarter of ``pending / workers / 2`` up to that size,
and never moves a queued item to an idle worker. The chunks grow with the
number of items still pending, and the port's files are collected last, so
every port item (a skipped one too) makes the chunks of the JAX tests
before it larger: a worker that receives a chunk of slow tests holds it
while the others run out of work. This script replays that rule on the
durations of a JUnit XML report and on the collection order of the tree
as it is now (items it has no duration for take ``--new-item-s``), with
each duration scaled by a slowdown factor and a lognormal noise.

    python -m pytest tests/ -m 'not slow' -p xdist -n 6 --dist load \\
        --junitxml=/tmp/t.xml                          # a measured run
    python tests/xdist_load_sim.py --xml /tmp/t.xml    # then replay
"""

import argparse
import heapq
import random
import subprocess
import sys
import xml.etree.ElementTree as ET

# the suite's command: 6 workers, a 1470 s cap; ~21 s pass before the first
# test; each duration scaled by a lognormal noise of sigma 0.2, 200 times
WORKERS, CAP, START, NOISE, REPS = 6, 1470.0, 21.0, 0.2, 200


def read_report(path):
    """{node id: seconds}, {node ids that skipped} of a JUnit XML report."""
    durations, skipped = {}, set()
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = case.get("classname").split(".")
        if parts[-1][:1].isupper():  # a test class
            cls = parts.pop()
            parts[-1] += ".py::" + cls
        else:
            parts[-1] += ".py"
        node = "/".join(parts) + "::" + case.get("name")
        durations[node] = float(case.get("time"))
        if case.find("skipped") is not None:
            skipped.add(node)
    return durations, skipped


def collect():
    """The node ids of the suite, in collection order."""
    out = subprocess.run([sys.executable, "-m", "pytest", "tests/", "-q", "-m", "not slow",
                          "--collect-only", "-p", "no:cacheprovider", "-p", "no:randomly"],
                         capture_output=True, text=True, check=False).stdout
    return [line.strip() for line in out.splitlines() if "::" in line]


def replay(items, seconds, passing, workers=WORKERS, start=START, cap=CAP):
    """(wall time, passes finished by ``cap``) of the load schedule."""
    pending = list(range(len(items)))
    queues = [[] for _ in range(workers)]

    def send(w, num):
        queues[w].extend(pending[:num])
        del pending[:num]

    for w in range(workers):
        send(w, max(len(items) // workers // 4, 2))
    clock = [(start + seconds[queues[w][0]], w) for w in range(workers) if queues[w]]
    heapq.heapify(clock)
    end, passes = start, 0
    while clock:
        t, w = heapq.heappop(clock)
        i = queues[w].pop(0)
        end = t
        passes += t <= cap and passing[i]
        if pending:
            low = max(2, len(pending) // workers // 4)
            high = max(2, len(pending) // workers // 2)
            long_test = seconds[i] >= 0.1 and len(queues[w]) >= 2
            if len(queues[w]) < low and not long_test:
                send(w, high - len(queues[w]))
        if queues[w]:
            heapq.heappush(clock, (t + seconds[queues[w][0]], w))
    return end, passes


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--xml", required=True, help="JUnit XML report of a measured run")
    p.add_argument("--order", help="file of node ids in collection order (default: collect now)")
    p.add_argument("--new-item-s", type=float, default=0.5,
                   help="duration of an item the report lacks")
    p.add_argument("--scales", default="1.0,1.1,1.2,1.3", help="slowdown factors")
    p.add_argument("--need", type=int, default=0, help="passes the run must reach")
    a = p.parse_args(argv)
    durations, skipped = read_report(a.xml)
    if a.order:
        with open(a.order) as f:
            items = [line.strip() for line in f if "::" in line]
    else:
        items = collect()
    base = [durations.get(i, a.new_item_s) for i in items]
    # an item the report lacks skips where every reported item of its file did
    files = {}
    for node in durations:
        files.setdefault(node.split("::")[0], []).append(node in skipped)
    passing = [i not in skipped if i in durations else not all(files.get(i.split("::")[0], [0]))
               for i in items]
    print(f"{len(items)} items, {sum(passing)} not skipped in the report, "
          f"{sum(i not in durations for i in items)} without a measured duration")
    for scale in (float(s) for s in a.scales.split(",")):
        ends, counts = [], []
        for rep in range(REPS):
            rng = random.Random(rep)
            seconds = [scale * s * rng.lognormvariate(0.0, NOISE) for s in base]
            end, passes = replay(items, seconds, passing)
            ends.append(end)
            counts.append(passes)
        ends.sort()
        counts.sort()
        q = lambda xs, f: xs[min(len(xs) - 1, int(f * len(xs)))]  # noqa: E731
        line = (f"x{scale:.2f}: wall p50 {q(ends, 0.5):.0f} s, p90 {q(ends, 0.9):.0f} s, "
                f"within the cap {sum(e <= CAP for e in ends) / REPS:.2f}; passes by the "
                f"cap p5 {q(counts, 0.05)}, p50 {q(counts, 0.5)}")
        if a.need:
            line += f", share reaching {a.need}: {sum(c >= a.need for c in counts) / REPS:.2f}"
        print(line)


if __name__ == "__main__":
    main()
