"""Several ranks over ``torch.distributed`` (``dcarl_tpu/parallel``).

The JAX package runs one SPMD program over a device mesh; here each rank
is one process on one device, and a :class:`~.mesh.ProcessMesh` names
its group.  ``collectives`` stands in for ``lax.all_gather``,
``psum_scatter``, ``psum`` and ``pmean``; ``launch.run_ranks`` starts
ranks on one host (the tests, and two ranks sharing one card)."""
