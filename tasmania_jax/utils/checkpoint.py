"""Native sharded checkpoint / resume.

The reference's only persistence path is host-side NetCDF via ``NetCDFMonitor``
(reference ``src/tasmania/utils/iox.py:47,299``; mirrored here by
``utils/iox.HDF5Monitor``).  For multi-chip runs a gather-to-host snapshot
does not scale, so this module adds the sharded equivalent called for by
SURVEY.md §5.4: an orbax/tensorstore checkpoint where every device writes its
own shards, and restore can re-shard onto a *different* mesh topology
(elastic resume).

State layout on disk: an arrays pytree ``{field_name: jax.Array}`` plus a JSON
metadata item carrying units, dims and the model time — enough to rebuild the
``FieldArray`` state dict on load.
"""

from __future__ import annotations

from datetime import datetime
from typing import Any, Dict, Mapping, Optional

import jax

from tasmania_jax.framework.field import FieldArray


def _split(state: Mapping[str, Any]):
    arrays: Dict[str, Any] = {}
    meta: Dict[str, Any] = {"fields": {}}
    for name, value in state.items():
        if name == "time":
            meta["time"] = value.isoformat()
            continue
        if isinstance(value, FieldArray):
            arrays[name] = value.data
            meta["fields"][name] = {"units": value.units, "dims": list(value.dims)}
        else:
            arrays[name] = value
            meta["fields"][name] = {"units": "1", "dims": []}
    return arrays, meta


def _join(arrays: Mapping[str, Any], meta: Mapping[str, Any]) -> Dict[str, Any]:
    state: Dict[str, Any] = {}
    if "time" in meta:
        state["time"] = datetime.fromisoformat(meta["time"])
    for name, arr in arrays.items():
        info = meta["fields"].get(name, {"units": "1", "dims": []})
        state[name] = FieldArray(arr, info["units"], tuple(info["dims"]))
    return state


class CheckpointManager:
    """Sharded save/restore of model states.

    ``save`` writes each device's shards directly (orbax/tensorstore OCDBT);
    ``restore`` accepts an optional ``sharding`` (a ``jax.sharding.Sharding``
    or a per-field dict of them) so a run checkpointed on one mesh can resume
    on another — including a single host.
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3) -> None:
        import orbax.checkpoint as ocp

        self._ocp = ocp
        self._mgr = ocp.CheckpointManager(
            directory,
            options=ocp.CheckpointManagerOptions(
                max_to_keep=max_to_keep, create=True
            ),
            item_names=("state", "meta"),
            # explicit handlers: a freshly opened manager (resume path) must
            # serve item_metadata() before any save/restore has registered them
            item_handlers={
                "state": ocp.StandardCheckpointHandler(),
                "meta": ocp.JsonCheckpointHandler(),
            },
        )

    def save(
        self,
        step: int,
        state: Mapping[str, Any],
        *,
        force: bool = False,
        wait: bool = False,
    ) -> bool:
        """``wait=True`` blocks until the shards are on disk — REQUIRED when
        the caller donates the same buffers to the next jitted step (XLA
        deletes them under the async serializer otherwise)."""
        ocp = self._ocp
        arrays, meta = _split(state)
        saved = self._mgr.save(
            step,
            args=ocp.args.Composite(
                state=ocp.args.StandardSave(arrays),
                meta=ocp.args.JsonSave(meta),
            ),
            force=force,
        )
        if wait:
            self._mgr.wait_until_finished()
        return bool(saved)

    def restore(
        self,
        step: Optional[int] = None,
        *,
        sharding=None,
    ) -> Dict[str, Any]:
        """Restore the state dict at ``step`` (default: latest).

        ``sharding`` re-lays-out every field on load: pass a single
        ``jax.sharding.Sharding`` for all fields or ``{name: sharding}`` (a
        field absent from the dict restores with its save-time layout).
        Without it, arrays restore with the layout recorded at save time; if
        those devices are absent in this process (e.g. an 8-device checkpoint
        opened single-host), the restore falls back to host-local numpy.
        """
        ocp = self._ocp
        if step is None:
            step = self._mgr.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")

        meta = self._mgr.restore(
            step, args=ocp.args.Composite(meta=ocp.args.JsonRestore())
        )["meta"]

        def _abstract(target_sharding):
            shapes = self._mgr.item_metadata(step)["state"]
            abstract = {}
            for name, m in shapes.items():
                if isinstance(target_sharding, dict):
                    sh = target_sharding.get(name)
                else:
                    sh = target_sharding
                abstract[name] = jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=sh)
            return ocp.args.Composite(state=ocp.args.StandardRestore(abstract))

        if sharding is not None:
            arrays = self._mgr.restore(step, args=_abstract(sharding))["state"]
        else:
            try:
                arrays = self._mgr.restore(
                    step, args=ocp.args.Composite(state=ocp.args.StandardRestore())
                )["state"]
            except (ValueError, RuntimeError):
                # save-time devices absent in this process: pull every shard
                # to the default device, hand back host-local numpy
                import numpy as _np

                single = jax.sharding.SingleDeviceSharding(jax.devices()[0])
                arrays = self._mgr.restore(step, args=_abstract(single))["state"]
                arrays = {k: _np.asarray(v) for k, v in arrays.items()}
        return _join(arrays, meta)

    @property
    def latest_step(self) -> Optional[int]:
        return self._mgr.latest_step()

    def all_steps(self):
        return self._mgr.all_steps()

    def wait_until_finished(self) -> None:
        self._mgr.wait_until_finished()

    def close(self) -> None:
        self._mgr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
