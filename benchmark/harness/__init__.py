"""The benchmark's harness: cells found by name, inputs from the seed,
the comparison that decides ``correct``, trace reading and the counted
work. It measures ``deblur4dgs_tpu_torch`` and nothing else."""
