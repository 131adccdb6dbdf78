"""Multi-writer safety via a conditional-write commit plane
(reference: blobstore/s3/ddb_commit_store.go — DynamoDB-CAS'd CURRENT).

Two writers share an object store WITHOUT atomic compare-and-swap (plain S3).
The DDB-style commit plane arbitrates the CURRENT pointer: exactly one of two
racing commits wins; the loser gets ErrConflict and must reload + retry.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from vecgo.blobstore import MemoryStore
from vecgo.blobstore.s3 import DDBCommitStore
from vecgo.engine import Engine, EngineOptions
from vecgo.engine.manifest import Manifest, ManifestStore
from vecgo.errors import ErrConflict


class FakeDDB:
    """In-memory stand-in for a DynamoDB client (conditional put_item)."""

    def __init__(self):
        self.items = {}

    def put_item(self, TableName, Item, ConditionExpression=None,
                 ExpressionAttributeValues=None):
        key = Item["db"]["S"]
        cur = self.items.get(key)
        if ConditionExpression == "attribute_not_exists(db)" and cur is not None:
            e = Exception("conditional")
            e.response = {"Error": {"Code": "ConditionalCheckFailedException"}}
            raise e
        if ConditionExpression == "version = :prev":
            prev = int(ExpressionAttributeValues[":prev"]["N"])
            if cur is None or int(cur["version"]["N"]) != prev:
                e = Exception("conditional")
                e.response = {"Error": {"Code": "ConditionalCheckFailedException"}}
                raise e
        self.items[key] = Item

    def get_item(self, TableName, Key):
        item = self.items.get(Key["db"]["S"])
        return {"Item": item} if item else {}


def main():
    blob = MemoryStore()  # stands in for plain S3 (no atomic CAS)
    ddb = FakeDDB()  # stands in for DynamoDB

    # Writer A creates the database with the commit plane enabled.
    opts = EngineOptions(
        dim=16, commit_store=DDBCommitStore(ddb, "commits", "mydb")
    )
    a = Engine.open(blob, opts, create=True)
    rng = np.random.default_rng(7)
    a.insert_batch(rng.standard_normal((500, 16)).astype(np.float32))
    a.commit()
    print("writer A committed version", a._version)

    # Two manifest writers race the same next version: the commit plane's
    # conditional write lets exactly one through.
    w1 = ManifestStore(blob, commit_store=DDBCommitStore(ddb, "commits", "mydb"))
    w2 = ManifestStore(blob, commit_store=DDBCommitStore(ddb, "commits", "mydb"))
    base = w1.current_version()
    m1 = Manifest(version=base + 1, lsn=999, next_id=1000, next_seg_id=9)
    m2 = Manifest(version=base + 2, lsn=998, next_id=1000, next_seg_id=9)
    w1.save(m1, expect_version=base)
    print("writer 1 won the commit race at version", base + 1)
    try:
        w2.save(m2, expect_version=base)  # stale view of CURRENT
        raise AssertionError("unreachable")
    except ErrConflict as e:
        print("writer 2 lost:", e)

    # Readers resolve CURRENT through the commit plane (authoritative).
    assert w2.current_version() == base + 1
    print("readers see version", w2.current_version())
    a.close()


if __name__ == "__main__":
    main()
