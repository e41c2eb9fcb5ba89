"""Vote-axis sharding over several devices in one process (counterpart of
``txflow_tpu/parallel``).

Each device verifies its shard of a padded vote batch and tallies it into
a partial; the partials cross devices by peer copies and every shard adds
them (the JAX package's ``psum``), or passes them around a ring. One
Python process drives every card, as JAX's ``shard_map`` runs in one
process over a ``Mesh``: there is no process group. ``staging.py`` holds
the readback ring the device verifier reads each step back through.
"""

from .mesh import (
    VOTE_AXIS,
    Mesh,
    make_mesh,
    ring_tally,
    sharded_compact_step,
    sharded_compact_step_packed,
    sharded_ring_step,
    sharded_verify_and_tally,
    to_host,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "ring_tally",
    "sharded_compact_step",
    "sharded_compact_step_packed",
    "sharded_ring_step",
    "sharded_verify_and_tally",
    "to_host",
    "VOTE_AXIS",
]
