"""The JAX repository's diagnostic scripts, ported: ``mpf1_convergence``,
``permu_diag``, ``corner_attrib``, ``multimu_diag``, ``window_study``,
``kernel_ledger`` and ``generate_goldens``, each run as ``python -m
romtime_tpu_torch.scripts.<name>`` with the JAX script's flags, on the
card unless given ``--device cpu``, each split into functions that take
the device and the working directory."""
