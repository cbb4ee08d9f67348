"""Pipelines: LightGCN training, eval and export; Adam under the staircase
decay, checkpoints, run statistics."""
