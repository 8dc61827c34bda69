"""Sharding of parameters and caches over a ``launch.mesh.Mesh``
(counterpart of ``repro.parallel``)."""
