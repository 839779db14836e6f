"""Wall-clock section timers.

Equivalent of deal.II TimerOutput as used by the reference
(reference: planet_geometry.tpp:13-16 setup; TimerOutput::Scope wraps
every phase, e.g. boussinesq_model.tpp:483-484, 695-696, 1139-1140;
periodic summary print tpp:1912-1916). Sections accumulate wall time
and call counts; ``summary()`` renders the same kind of table. For
device work, callers should block (torch.cuda.synchronize) inside the
scope; deeper profiling goes through torch.profiler traces.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator


@dataclass
class Timer:
    calls: int = 0
    total: float = 0.0


@dataclass
class TimerRegistry:
    sections: Dict[str, Timer] = field(default_factory=dict)
    _t0: float = field(default_factory=time.perf_counter)

    @contextmanager
    def scope(self, name: str) -> Iterator[None]:
        t = self.sections.setdefault(name, Timer())
        start = time.perf_counter()
        try:
            yield
        finally:
            t.calls += 1
            t.total += time.perf_counter() - start

    def summary(self) -> str:
        """Render an aggregate table (analogue of
        TimerOutput::print_summary, wall times)."""
        total_wall = time.perf_counter() - self._t0
        width = max([len(n) for n in self.sections] + [20])
        lines = [
            "+" + "-" * (width + 36) + "+",
            f"| Total wallclock time elapsed: {total_wall:10.3g}s".ljust(width + 37) + "|",
            "|" + " " * (width + 36) + "|",
            f"| {'Section'.ljust(width)} | calls |  wall time | % of total |",
        ]
        for name in sorted(self.sections):
            t = self.sections[name]
            pct = 100.0 * t.total / total_wall if total_wall > 0 else 0.0
            lines.append(
                f"| {name.ljust(width)} | {t.calls:5d} | {t.total:9.3g}s | {pct:9.2f}% |"
            )
        lines.append("+" + "-" * (width + 36) + "+")
        return "\n".join(lines)
