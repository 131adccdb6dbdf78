"""Containment for a jax-0.9.0 executable-reuse bug.

Observed on the XLA:CPU backend: after certain compiled programs have run in
a process (sort/roll-heavy graph-build kernels), a later — differently-shaped,
otherwise-correct — jitted call fails at dispatch with INVALID_ARGUMENT
("Execution supplied 5 buffers but compiled program expected 6 buffers").
Deterministic repro: run index/build_fast._prune_all once, then
FreshVamana.insert_batch — the first robust_prune dispatch fails; the exact
same call succeeds in a fresh process or after jax.clear_caches().

`call_compiled` wraps a jitted call: on that signature it retries once after a
barrier, then clears the jit caches (one recompile; the persistent compile
cache softens it) and retries again. Correctness is unaffected — only
compile time is re-paid.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("vecgo")

_ERRORS = None


def _errors():
    global _ERRORS
    if _ERRORS is None:
        import jax

        _ERRORS = (jax.errors.JaxRuntimeError, ValueError, RuntimeError)
    return _ERRORS


def dispatch_guarded(fn, *args):
    """Dispatch a jitted call with containment for the re-execution bug.

    Observed deterministic failure mode (XLA:CPU, jax 0.9.0): after a specific mix of large compiled programs has run
    (a full graph build), RE-EXECUTING certain other executables fails at
    dispatch with INVALID_ARGUMENT ("Execution supplied 5 buffers but
    compiled program expected 6 buffers") — the freshly recompiled program
    always runs once correctly. Bisect notes: each build stage alone does
    NOT poison; only the full build sequence does; the jit wrapper
    structure was ruled out. chip_smoke.py phase 4 counts the retries on
    the GPU.

    Containment: clear the jit caches and retry once (recompile; the
    persistent compile cache keeps this cheap)."""
    import jax

    try:
        return fn(*args)
    except _errors() as e:
        if "INVALID_ARGUMENT" not in str(e):
            raise
        logger.warning("jit dispatch failed (%s); clearing caches + retrying", e)
        jax.clear_caches()
        return fn(*args)


def call_compiled(fn, *args, **kwargs):
    """Invoke a jitted function, containing the executable-reuse bug."""
    import jax

    try:
        return jax.block_until_ready(fn(*args, **kwargs))
    except _errors() as e:
        if "INVALID_ARGUMENT" not in str(e):
            raise
        logger.warning("compiled call failed (%s); retrying after barrier", e)
    try:
        return jax.block_until_ready(fn(*args, **kwargs))
    except _errors() as e:
        if "INVALID_ARGUMENT" not in str(e):
            raise
        logger.warning("compiled call failed again; clearing jit caches")
        jax.clear_caches()
        import gc

        gc.collect()  # release device executables held only by cleared caches
        return jax.block_until_ready(fn(*args, **kwargs))
