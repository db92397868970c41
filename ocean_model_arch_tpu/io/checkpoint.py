"""Checkpoint / resume of the full prognostic state.

The reference's resume capability is minimal (ssh-from-file only,
SURVEY.md §5.4); here the full prognostic tuple (all three time levels of
ssh/u/v, the depth families, tracers) plus the step counter round-trips,
so a run restarts bit-exactly. Plain .npz container (no external deps);
the arrays are host-gathered, so this also works for sharded states.
"""

from __future__ import annotations

import dataclasses
import os

import jax.numpy as jnp
import numpy as np

from ..core.state import SWState


def save_checkpoint(path: str, state: SWState, step: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is not None:
            arrays[f.name] = np.asarray(v)
    arrays["__step__"] = np.asarray(step, np.int64)
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)


def load_checkpoint(path: str) -> tuple[SWState, int]:
    with np.load(path) as z:
        step = int(z["__step__"])
        kwargs = {}
        for f in dataclasses.fields(SWState):
            kwargs[f.name] = (jnp.asarray(z[f.name])
                              if f.name in z.files else None)
    return SWState(**kwargs), step


# ---------------------------------------------------------------------
# Sharded (multi-host) checkpointing via orbax/tensorstore: each process
# writes its own shards — the analog of the reference's collective MPI-IO
# (tools/io.f90:276-498), where every rank writes its block subarrays
# into one file. No host gather, restores with the target sharding in
# place. orbax is optional: only these two functions import it.

def _orbax():
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "sharded checkpoints (--ckpt-format orbax) need the "
            "'orbax-checkpoint' package, which is not installed; use the "
            "default npz format") from e
    return ocp


def save_checkpoint_sharded(path: str, state: SWState, step: int) -> None:
    """Write the full prognostic pytree + step counter with orbax.
    ``state`` may hold sharded jax.Arrays over any mesh; every process
    participates (call from all hosts)."""
    ocp = _orbax()
    tree = {f.name: getattr(state, f.name)
            for f in dataclasses.fields(state)
            if getattr(state, f.name) is not None}
    tree["__step__"] = np.asarray(step, np.int64)
    ckptr = ocp.PyTreeCheckpointer()
    ckptr.save(os.path.abspath(path), tree, force=True)


def load_checkpoint_sharded(path: str, shardings=None
                            ) -> tuple[SWState, int]:
    """Restore a sharded checkpoint. ``shardings``: optional
    {field_name: jax.sharding.Sharding} — fields restore directly into
    that placement (each process reads only its shards); unlisted fields
    restore as host arrays."""
    import jax
    ocp = _orbax()

    ckptr = ocp.PyTreeCheckpointer()
    if shardings:
        meta = ckptr.metadata(os.path.abspath(path)).item_metadata.tree
        restore_args = {
            k: (ocp.ArrayRestoreArgs(sharding=shardings[k])
                if k in shardings else ocp.RestoreArgs())
            for k in meta}
        tree = ckptr.restore(os.path.abspath(path),
                             restore_args=restore_args)
    else:
        tree = ckptr.restore(os.path.abspath(path))
    step = int(np.asarray(tree.pop("__step__")))
    kwargs = {}
    for f in dataclasses.fields(SWState):
        v = tree.get(f.name)
        if v is None:
            kwargs[f.name] = None
        elif isinstance(v, jax.Array):
            kwargs[f.name] = v
        else:
            kwargs[f.name] = jnp.asarray(v)
    return SWState(**kwargs), step
