"""Sharded fleets over a ``(world, particle)`` device mesh."""

from slamrs_tpu_torch.parallel.fleet import (  # noqa: F401
    fleet_shardings,
    make_mesh,
    shard_world_state,
    unshard_world_state,
)
