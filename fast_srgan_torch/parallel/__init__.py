"""Multi-device serving and data-parallel training.

The port of ``fast_srgan_tpu/parallel/``. A :class:`~.mesh.Mesh` is a 1-D or
2-D grid of ``torch.device``s in one process (as JAX's ``shard_map`` runs
over a process's local devices); ``spatial.py`` shards each frame's width
across it, exactly. The engine's data-parallel ``mesh=`` is in
``inference.py``. ``dist.py`` holds the processes of a data-parallel
training run (``torch.distributed``, one rank a device, launched by
``torchrun``).
"""
