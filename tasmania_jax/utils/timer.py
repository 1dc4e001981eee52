"""Hierarchical timer (reference ``src/tasmania/utils/timex.py:95,105``).

The reference syncs the CUDA device at every tic/toc; the JAX analogue is
``jax.block_until_ready`` at node boundaries — but *only when enabled*, because
inside ``jax.jit`` tracing the timed region runs once at trace time and the
timings would be meaningless.  Drivers therefore time whole jitted steps
(``Timer.enabled = True`` + explicit ``block_until_ready`` on outputs), and the
per-component ``Timer.timing`` labels used inside components are no-ops unless
explicitly switched on for eager-mode debugging.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional


class _Node:
    __slots__ = ("label", "children", "total", "count", "_tic")

    def __init__(self, label: str) -> None:
        self.label = label
        self.children: Dict[str, "_Node"] = {}
        self.total = 0.0
        self.count = 0
        self._tic: Optional[float] = None


class Timer:
    """Class-level hierarchical timer: ``Timer.start(label)`` / ``Timer.stop()``."""

    enabled: bool = False
    sync: bool = True  # block_until_ready at stop when given a value to sync on
    _root: _Node = _Node("root")
    _stack: List[_Node] = [_root]

    # -- control ------------------------------------------------------------- #
    @classmethod
    def reset(cls) -> None:
        cls._root = _Node("root")
        cls._stack = [cls._root]

    @classmethod
    def start(cls, label: str) -> None:
        if not cls.enabled:
            return
        parent = cls._stack[-1]
        node = parent.children.get(label)
        if node is None:
            node = _Node(label)
            parent.children[label] = node
        node._tic = time.perf_counter()
        cls._stack.append(node)

    @classmethod
    def stop(cls, sync_on=None) -> None:
        if not cls.enabled:
            return
        if sync_on is not None and cls.sync:
            import jax

            jax.block_until_ready(sync_on)
        node = cls._stack.pop()
        node.total += time.perf_counter() - node._tic
        node.count += 1

    @classmethod
    @contextlib.contextmanager
    def timing(cls, label: str, sync_on=None):
        cls.start(label)
        try:
            yield
        finally:
            cls.stop(sync_on)

    # -- reporting ----------------------------------------------------------- #
    @classmethod
    def get_time(cls, label: str, units: str = "s") -> float:
        """Aggregate total across all tree nodes carrying ``label``."""
        factor = {"s": 1.0, "ms": 1e3, "us": 1e6}[units]

        def walk(node: _Node) -> float:
            acc = node.total if node.label == label else 0.0
            return acc + sum(walk(c) for c in node.children.values())

        return walk(cls._root) * factor

    @classmethod
    def to_csv(cls, path: str, run_label: str = "", backend: str = "jax") -> None:
        """Append per-node rows (reference drivers' ``exec_info_to_csv`` /
        ``run_info_to_csv`` role, SURVEY.md §5.5)."""
        import csv
        import os

        rows = []

        def walk(node: _Node, prefix: str) -> None:
            label = f"{prefix}/{node.label}" if prefix else node.label
            if node.count:
                rows.append((run_label, backend, label, node.total, node.count))
            for c in node.children.values():
                walk(c, label)

        for c in cls._root.children.values():
            walk(c, "")
        write_header = not os.path.exists(path)
        with open(path, "a", newline="") as f:
            w = csv.writer(f)
            if write_header:
                w.writerow(["run", "backend", "label", "total_s", "calls"])
            w.writerows(rows)

    @classmethod
    def log(cls, out=None, units: str = "s") -> str:
        factor = {"s": 1.0, "ms": 1e3, "us": 1e6}[units]
        lines: List[str] = []

        def walk(node: _Node, depth: int) -> None:
            if depth >= 0:
                lines.append(
                    f"{'  ' * depth}{node.label}: "
                    f"{node.total * factor:.3f} {units} ({node.count} calls)"
                )
            for c in node.children.values():
                walk(c, depth + 1)

        walk(cls._root, -1)
        text = "\n".join(lines)
        if out is not None:
            with open(out, "w") as f:
                f.write(text + "\n")
        return text


import contextlib as _contextlib


@_contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a jax.profiler xplane trace around a code block
    (SURVEY.md §5.1: the reference's per-kernel exec_info role)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
