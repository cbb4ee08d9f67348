"""Model layer: LightGCN."""
