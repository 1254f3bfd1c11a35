"""Artifact serialization: save/load precomputed tables and caches as npz.

The reference persists `CunninghamTransferTable`s as table artifacts for the
spectral-fitting model (`src/transfer-functions/types.jl:14-118`,
`lib/GradusSpectralModels`) and reuses `EndpointRenderCache` to re-apply point
functions without re-tracing (`src/rendering/cache.jl:1-59`). This module is
the JAX equivalent: any registered pytree dataclass (tables, grids,
profiles, render caches — including nested metrics / GeodesicPoint payloads)
round-trips through a single portable ``.npz`` file (no pickle)."""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np

__all__ = ["save_npz", "load_npz"]


def _registry():
    """Name → class map of every serializable dataclass in the package."""
    import gradus_tpu as gt
    from gradus_tpu.transfer.cunningham import TransferBranchGrid
    from gradus_tpu.transfer.tables import CunninghamTransferTable
    from gradus_tpu.corona.profiles import RadialDiscProfile
    from gradus_tpu.camera.render import EndpointRenderCache
    from gradus_tpu.integrate.points import GeodesicPoint

    classes = [
        TransferBranchGrid,
        CunninghamTransferTable,
        RadialDiscProfile,
        EndpointRenderCache,
        GeodesicPoint,
    ]
    # all exported dataclasses (metrics, discs, corona models, ...)
    for name in dir(gt):
        obj = getattr(gt, name)
        if isinstance(obj, type) and dataclasses.is_dataclass(obj):
            classes.append(obj)
    # extended-corona profiles
    try:
        from gradus_tpu.corona import profiles as _profiles

        for name in dir(_profiles):
            obj = getattr(_profiles, name)
            if isinstance(obj, type) and dataclasses.is_dataclass(obj):
                classes.append(obj)
    except ImportError:  # pragma: no cover
        pass
    return {cls.__name__: cls for cls in classes}


def save_npz(path, obj) -> None:
    """Serialize a (possibly nested) registered dataclass / array pytree to
    ``path`` as a portable npz (structure as JSON + numbered array payloads)."""
    arrays: list[np.ndarray] = []

    def enc(o):
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return {
                "__dc__": type(o).__name__,
                "fields": {
                    f.name: enc(getattr(o, f.name))
                    for f in dataclasses.fields(o)
                },
            }
        if isinstance(o, (jnp.ndarray, np.ndarray, np.generic)):
            arrays.append(np.asarray(o))
            return {"__arr__": len(arrays) - 1}
        if o is None:
            return {"__none__": True}
        if isinstance(o, (bool, int, float, str)):
            return o
        if isinstance(o, (list, tuple)):
            return {"__seq__": [enc(v) for v in o], "tuple": isinstance(o, tuple)}
        raise TypeError(
            f"cannot serialize {type(o).__name__} (analytic callables and "
            "custom objects are not npz-serializable)"
        )

    tree = enc(obj)
    np.savez(
        path,
        __tree__=np.asarray(json.dumps(tree)),
        **{f"arr_{i}": a for i, a in enumerate(arrays)},
    )


def load_npz(path):
    """Inverse of `save_npz`. Arrays are restored as jax arrays."""
    registry = _registry()
    with np.load(path, allow_pickle=False) as data:
        tree = json.loads(str(data["__tree__"]))
        arrays = {
            int(k[4:]): data[k] for k in data.files if k.startswith("arr_")
        }

    def dec(o):
        if isinstance(o, dict):
            if "__dc__" in o:
                cls = registry.get(o["__dc__"])
                if cls is None:
                    raise KeyError(f"unknown serialized class {o['__dc__']!r}")
                kwargs = {k: dec(v) for k, v in o["fields"].items()}
                return cls(**kwargs)
            if "__arr__" in o:
                return jnp.asarray(arrays[o["__arr__"]])
            if "__none__" in o:
                return None
            if "__seq__" in o:
                seq = [dec(v) for v in o["__seq__"]]
                return tuple(seq) if o.get("tuple") else seq
        return o

    return dec(tree)
