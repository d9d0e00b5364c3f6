"""Versioned full-state checkpointing (port of `repro.checkpoint`):
the legacy single-file `save`/`restore` pair (params-only export) and
the manifest-based `save_state`/`restore_state` subsystem with
`latest_step`/`checkpoint_steps` discovery and `clean_orphans`
crash-residue cleanup, in the JAX package's on-disk format.  See the
submodule docstring for the layout and the verification protocol.
"""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    ARRAYS_NAME,
    MANIFEST_NAME,
    CheckpointError,
    checkpoint_nbytes,
    checkpoint_steps,
    clean_orphans,
    flatten_tree,
    latest_step,
    read_manifest,
    resolve_checkpoint,
    restore,
    restore_state,
    save,
    save_state,
    tree_fingerprint,
)

__all__ = [
    "ARRAYS_NAME", "MANIFEST_NAME", "CheckpointError",
    "checkpoint_nbytes", "checkpoint_steps", "clean_orphans",
    "flatten_tree", "latest_step", "read_manifest", "resolve_checkpoint",
    "restore", "restore_state", "save", "save_state", "tree_fingerprint",
]
