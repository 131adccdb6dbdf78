"""Public API facade (reference: vecgo.go:17-448, doc.go).

    import vecgo

    db = vecgo.Open(vecgo.Local("/data/db"), vecgo.Create(dim=128))
    id = db.insert(vec, metadata={"cat": "a"})
    db.commit()
    for hit in db.search(q, k=10, filter=vecgo.metadata.eq("cat", "a")):
        print(hit.id, hit.distance)

Backends: Local(dir) / Remote(store) / Memory(). Remote(read_only=True) gives
the stateless read-replica mode (reference: vecgo.Remote, engine.go:380-420) —
many readers over one shared store, single writer via manifest CAS.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

from vecgo.blobstore import BlobStore, LocalStore, MemoryStore
from vecgo.engine import Engine, EngineOptions
from vecgo.model import Metric


@dataclass
class Backend:
    store: Any
    read_only: bool = False


def Local(path: str) -> Backend:
    """Local filesystem backend (reference: vecgo.Local)."""
    return Backend(store=path)


def Remote(store: BlobStore, read_only: bool = False) -> Backend:
    """Shared blob-store backend; read_only=True for stateless read replicas
    (reference: vecgo.Remote, vecgo.go:151-179)."""
    return Backend(store=store, read_only=read_only)


def Memory() -> Backend:
    """Ephemeral in-memory backend (tests/experiments)."""
    return Backend(store=MemoryStore())


def Create(dim: int, metric: Metric = Metric.L2, **kw) -> EngineOptions:
    """Creation options (reference: vecgo.Create(dim, metric))."""
    return EngineOptions(dim=dim, metric=metric, **kw)


class DB:
    """Embeddable handle; thin delegation to the engine (reference: vecgo.DB)."""

    def __init__(self, engine: Engine):
        self.engine = engine

    # CRUD
    def insert(self, vector, metadata=None, payload=None, text=None, id=None) -> int:
        return self.engine.insert(vector, metadata, payload, text, id)

    def insert_batch(self, vectors, metadatas=None, payloads=None, texts=None, ids=None):
        return self.engine.insert_batch(vectors, metadatas, payloads, texts, ids)

    def delete(self, id: int) -> bool:
        return self.engine.delete(id)

    def get(self, id: int):
        return self.engine.get(id)

    def scan(self):
        return self.engine.scan()

    # Search
    def search(self, q, k: int = 10, **kw):
        return self.engine.search(q, k, **kw)

    def search_iter(self, q, k: int = 10, **kw):
        """Iterator over candidates best-first (reference: SearchIter,
        engine/search.go:120). Results are computed in one device batch; the
        iterator form is API parity for streaming consumers."""
        yield from self.engine.search(q, k, **kw)

    def search_batch(self, qs, k: int = 10, **kw):
        return self.engine.search_batch(qs, k, **kw)

    def search_arrays(self, qs, k: int = 10, **kw):
        """Bulk serving path: (ids, dists) arrays, pipelined chunks."""
        return self.engine.search_arrays(qs, k, **kw)

    def search_arrays_stream(self, batches, k: int = 10, depth: int = 3, **kw):
        """Sustained serving: keep `depth` query batches in flight; yields
        (ids, dists) per batch (one consistent snapshot for the stream)."""
        return self.engine.search_arrays_stream(batches, k, depth=depth, **kw)

    def hybrid_search(self, q, text: str, k: int = 10, **kw):
        return self.engine.hybrid_search(q, text, k, **kw)

    def hybrid_search_batch(self, qs, texts, k: int = 10, **kw):
        return self.engine.hybrid_search_batch(qs, texts, k, **kw)

    def sharded_searcher(self, mesh):
        """Multi-chip searcher over the committed snapshot (parallel plane)."""
        return self.engine.sharded_searcher(mesh)

    # Durability / maintenance
    def commit(self) -> int:
        return self.engine.commit()

    def compact(self, seg_ids=None):
        return self.engine.compact(seg_ids)

    def vacuum(self):
        return self.engine.vacuum()

    def versions(self):
        return self.engine.versions()

    def stats(self):
        return self.engine.stats()

    def close(self):
        self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def Open(
    backend: Backend,
    options: Optional[EngineOptions] = None,
    version: Optional[int] = None,
    as_of: Optional[float] = None,
) -> DB:
    """Open or create a database (reference: vecgo.Open, vecgo.go:80).

    `version`/`as_of` open a read-only time-travel view (reference:
    WithVersion/WithTimestamp, engine.go:289-313).
    """
    create = options is not None and options.dim > 0
    if backend.read_only:
        options = options or EngineOptions()
        options.read_only = True
    eng = Engine.open(
        backend.store, options, version=version, as_of=as_of, create=create
    )
    return DB(eng)
