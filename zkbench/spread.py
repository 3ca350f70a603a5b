#!/usr/bin/env python3
"""Medians and spreads of runs' results, as the bounds are set from them.

    python3 zkbench/spread.py RUN.out [RUN.out ...]

Each file is a run's standard output: its first line names the workload
(``# zkbench <workload> seed ...``) and its last line is the result.  For
each workload and metric: the number of runs, the median, and the spread,
the distance between the first and third quartiles of Python's
``statistics.quantiles(values, n=4)`` as a share of the median.
"""

from __future__ import annotations

import collections
import json
import statistics
import sys


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def table(paths) -> dict:
    """{workload: {metric: [values]}} over the runs in ``paths`` whose
    result says correct."""
    out = collections.defaultdict(lambda: collections.defaultdict(list))
    for path in paths:
        lines = open(path).read().splitlines()
        if not lines or not lines[0].startswith("# zkbench "):
            continue
        workload = lines[0].split()[2]
        result = json.loads(lines[-1])
        if not result["correct"]:
            continue
        for name, m in result["metrics"].items():
            out[workload][name].append(m["value"])
    return out


def main(paths) -> None:
    for workload, metrics in sorted(table(paths).items()):
        for name, values in sorted(metrics.items()):
            line = f"{workload} {name} n={len(values)} median={statistics.median(values)}"
            if len(values) >= 2:
                line += f" spread={spread(values)}"
            print(line)


if __name__ == "__main__":
    main(sys.argv[1:])
