"""Replay how ``pytest -n 6 --dist loadfile`` spreads the test files of a
run over its workers, from the run's JUnit XML, outside the suite.

    python tests/xdist_schedule.py <junit.xml> [--without <substring>...]

xdist's ``loadfile`` queues the files by their number of tests, most
first (ties in collection order), hands each worker two files, then the
next file to whichever worker finishes first. The replay does the same
with each file's seconds from the XML (setup, call and teardown of its
tests) and prints the wall time the last worker finishes at; with
``--without``, also the replay of the files whose path contains none of
the substrings, and the difference: what those files add to the run's
wall time. The replay ignores worker start-up and contention between
workers.
"""

import collections
import heapq
import sys
import xml.etree.ElementTree as ET


def files(path):
    """``({file: tests}, {file: seconds})`` in the XML's order."""
    count, seconds = collections.OrderedDict(), collections.Counter()
    for case in ET.parse(path).iter("testcase"):
        name = case.get("classname").replace(".", "/") + ".py"
        count[name] = count.get(name, 0) + 1
        seconds[name] += float(case.get("time"))
    return count, seconds


def replay(count, seconds, workers=6):
    """The time the last of ``workers`` finishes."""
    queue = sorted(count, key=lambda f: -count[f])  # stable: ties keep order
    busy = [0.0] * workers
    for _ in range(2):
        for w in range(workers):
            if queue:
                busy[w] += seconds[queue.pop(0)]
    heap = [(t, w) for w, t in enumerate(busy)]
    heapq.heapify(heap)
    while queue:
        t, w = heapq.heappop(heap)
        heapq.heappush(heap, (t + seconds[queue.pop(0)], w))
    return max(t for t, _ in heap)


def main(argv):
    count, seconds = files(argv[0])
    total = replay(count, seconds)
    print(f"replayed wall time: {total:.1f} s "
          f"({sum(seconds.values()):.1f} s of tests)")
    if "--without" in argv:
        drop = argv[argv.index("--without") + 1:]
        kept = collections.OrderedDict(
            (f, n) for f, n in count.items() if not any(d in f for d in drop))
        rest = replay(kept, seconds)
        print(f"without the files matching {drop}: {rest:.1f} s; they add "
              f"{total - rest:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:])
