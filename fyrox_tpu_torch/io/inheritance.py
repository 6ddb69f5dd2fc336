"""Prefab property inheritance: delta computation + resync (the port's
copy of ``fyrox_tpu.io.inheritance``, over the port's SceneTemplate).

Equivalent of the reference's InheritableVariable machinery
(fyrox-core/src/variable.rs:41-44 MODIFIED/NEED_SYNC flags): a scene node
instantiated from a prefab stores only the fields its author MODIFIED;
everything else re-reads from the prefab on load, so prefab edits
propagate to every instance (`try_sync_model`).

The engine's scene description is the static SceneTemplate, so the
mechanism operates there:

    deltas = compute_deltas(prefab, instance, node_offset)
        — per-node dict of overridden field values (only differences)
    merged = apply_deltas(prefab_template_rebuilt, deltas)
        — re-instantiate from a (possibly edited) prefab and replay the
          author's modifications on top

`deltas` is a plain JSON/Visitor-serializable dict, i.e. the delta-save
payload a .rgs instance node would carry instead of full values.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["compute_deltas", "apply_deltas", "TRACKED_FIELDS"]

# per-node template arrays participating in inheritance (the reference
# wraps the same node fields in InheritableVariable)
TRACKED_FIELDS = ("init_position", "init_rotation", "init_scale",
                  "init_visibility", "init_enabled")


def compute_deltas(prefab, instance, node_offset=0) -> Dict:
    """Field values of `instance` nodes [node_offset:...] differing from
    the prefab's nodes [0:N). Returns {local_node_idx: {field: value}}."""
    n = prefab.num_nodes
    out = {}
    for i in range(n):
        j = node_offset + i
        mods = {}
        for f in TRACKED_FIELDS:
            pv = getattr(prefab, f)[i]
            iv = getattr(instance, f)[j]
            same = (np.allclose(pv, iv, atol=1e-7)
                    if isinstance(pv, np.ndarray) or np.ndim(pv)
                    else pv == iv)
            if not same:
                mods[f] = (np.asarray(iv).tolist()
                           if (isinstance(iv, np.ndarray) or np.ndim(iv))
                           else iv)
        if mods:
            out[i] = mods
    return out


def apply_deltas(template, deltas: Dict, node_offset=0):
    """Replay modification deltas onto a (re)instantiated template —
    the load-side half of try_sync_model: unmodified fields keep the
    prefab's (possibly updated) values, modified ones keep the author's."""
    import dataclasses
    updates = {}
    for f in TRACKED_FIELDS:
        arr = np.array(getattr(template, f))
        touched = False
        for local_idx, mods in deltas.items():
            if f in mods:
                arr[node_offset + int(local_idx)] = mods[f]
                touched = True
        if touched:
            updates[f] = arr
    if not updates:
        return template
    return dataclasses.replace(template, **updates)
