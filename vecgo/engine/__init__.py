"""Engine: LSM orchestration, MVCC/durability plane, search planner (host).

Reference: internal/engine (engine.go, search.go, snapshot.go, compaction.go),
internal/manifest, internal/pk. The accelerator only ever sees dense arrays;
everything in this package is host-side control plane (SURVEY.md §7.1
host/device split).
"""

from vecgo.engine.engine import Engine, EngineOptions

__all__ = ["Engine", "EngineOptions"]
