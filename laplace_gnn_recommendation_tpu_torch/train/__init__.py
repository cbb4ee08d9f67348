"""Pipelines: the LightGCN eval and export subset."""
