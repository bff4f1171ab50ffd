"""The JAX repository's examples, ported: ``poisson_tutorial``,
``heat_2d`` and ``piston_rom``, each run as ``python -m
romtime_tpu_torch.examples.<name>`` on the card (``--device cpu`` for the
host), each split into functions that take the device."""
