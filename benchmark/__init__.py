"""The benchmark of volcano_tpu_torch: ``run.py`` runs one cell once."""
