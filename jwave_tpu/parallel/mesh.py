"""Device mesh construction and multi-host initialization."""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

from ..exceptions import JWaveFailure


def make_mesh(shape: tuple[int, ...] | int | None = None, axis_names: tuple[str, ...] = ("shard",)) -> Mesh:
    """Build a Mesh over the first ``prod(shape)`` devices, in JAX's order.

    ``shape=None`` uses all devices on one axis. The GPUs of one host are
    joined all to all (NVLink), so the device order carries no topology and
    the mesh follows the algorithm alone.
    """
    if shape is None:
        shape = (len(jax.devices()),)
    elif isinstance(shape, int):
        shape = (shape,)
    need = int(np.prod(shape))
    have = jax.devices()
    if need > len(have):
        raise JWaveFailure(f"make_mesh - mesh {shape} needs {need} devices, have {len(have)}")
    devices = np.asarray(have[:need]).reshape(shape)
    if len(axis_names) != len(shape):
        axis_names = tuple(f"ax{i}" for i in range(len(shape)))
    return Mesh(devices, axis_names)


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None):
    """Multi-host runtime bring-up (`jax.distributed.initialize`).

    The reference is single-JVM (SURVEY.md §5.8); this is the multi-host
    entry this library adds. No-ops when already initialized.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialized
    except ValueError:
        pass  # single-process environment without auto-detectable cluster
    return jax.process_index(), jax.process_count()
