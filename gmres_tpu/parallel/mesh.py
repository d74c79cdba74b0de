"""Device-mesh construction and vector placement.

The reference's entire parallelism story is a single OpenMP fork-join
region (SURVEY §2 C14). The replacement here: a 1-D (or
host×device 2-D) ``jax.sharding.Mesh`` over which grid vectors are
row-partitioned. The solvers are written in pure jnp, so placing the
inputs is the ONLY distribution step — under jit, XLA turns dot
products into ``psum`` all-reduces (NCCL on GPUs) and the stencil's
row shifts into collective-permute halo exchanges. One device and N
hosts run the same program.

Gotcha encoded here: current JAX defaults ``make_mesh`` to *Explicit*
axis types; the solvers rely on automatic (GSPMD) propagation, so the
mesh must be built with ``AxisType.Auto``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec


GRID_AXIS = "grid"


def solver_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """1-D mesh over all (or the first n) devices, axis name "grid",
    with Auto axis types so GSPMD propagates shardings through the
    solver bodies."""
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices but only {len(devs)} "
                f"available"
            )
        devs = devs[:n_devices]
    return jax.make_mesh(
        (len(devs),), (GRID_AXIS,), axis_types=(AxisType.Auto,),
        devices=devs,
    )


def grid_sharding(mesh: Mesh) -> NamedSharding:
    """Row-partition an (N, N) grid vector over the mesh (the
    block-row domain decomposition of SURVEY §2's parallelism list)."""
    return NamedSharding(mesh, PartitionSpec(GRID_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard_grid_vector(x: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Place an (N, N) grid vector row-sharded over the mesh. N must be
    divisible by the mesh size (pad the grid otherwise)."""
    n_rows_shards = dict(
        zip(mesh.axis_names, mesh.devices.shape)
    ).get(GRID_AXIS, mesh.devices.size)
    if x.shape[0] % n_rows_shards != 0:
        raise ValueError(
            f"grid rows ({x.shape[0]}) must divide evenly across the "
            f"{n_rows_shards}-way '{GRID_AXIS}' mesh axis; pad the "
            f"grid to a multiple of {n_rows_shards} rows (Dirichlet "
            f"zero-padding preserves the operator on the original "
            f"region)"
        )
    return jax.device_put(x, grid_sharding(mesh))


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Mesh:
    """Multi-host setup: ``jax.distributed.initialize`` + a 1-D mesh
    over every device of every host.

    The same SPMD solver program then runs unchanged — this is the
    capability the reference fundamentally lacks (its parallelism stops
    at one shared-memory process, SURVEY §2 C14). Pass all three
    arguments where no cluster environment provides them (e.g.
    ``coordinator_address="localhost:<port>"`` on one host).
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return solver_mesh()
