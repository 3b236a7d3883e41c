"""Multi-device bundle adjustment over ``torch.distributed``: meshes of
ranks (``mesh``, ``multihost``), the sharded solvers (``sharded_ba``) and
the launcher that starts the ranks (``launch``).

Counterpart of ``coebslam_tpu/parallel``. The JAX package runs one
controller over a ``jax.sharding.Mesh`` of devices with ``shard_map``;
here each device is one process (a rank), every rank calls the solver with
the whole problem, slices its own shard, and the per-iteration ``psum``
becomes an ``all_reduce`` over the ranks of the mesh axis.
"""
