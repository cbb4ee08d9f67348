"""Batch visualization: a bipartite plot of one sampled subgraph batch — the
port of the JAX package's ``utils/visualize.py`` (reference
``utils/visualize.py:78-141``): grey subgraph edges, green positive and red
negative label edges, customers on the left, articles on the right.
matplotlib and networkx are imported when a batch is drawn.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..data.sampler import SubgraphBatch


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def visualize_batch(batch: SubgraphBatch, out_path: Optional[str] = None):
    """Render one batch (host arrays or tensors on any device); returns the
    matplotlib figure, saved to ``out_path`` when one is given."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import networkx as nx

    g = nx.Graph()
    users = [f"c{i}" for i in np.flatnonzero(_host(batch.user_mask))]
    items = [f"a{i}" for i in np.flatnonzero(_host(batch.item_mask))]
    g.add_nodes_from(users, bipartite=0)
    g.add_nodes_from(items, bipartite=1)

    em = _host(batch.edge_mask)
    sub_edges = [(f"c{s}", f"a{d}")
                 for s, d in zip(_host(batch.edge_src)[em], _host(batch.edge_dst)[em])]
    lm, lab = _host(batch.label_mask), _host(batch.label)
    lsrc, ldst = _host(batch.label_src), _host(batch.label_dst)
    pos_edges, neg_edges = [], []
    for row in range(lm.shape[0]):
        for col in np.flatnonzero(lm[row]):
            e = (f"c{int(lsrc[row, col])}", f"a{int(ldst[row, col])}")
            (pos_edges if lab[row, col] > 0 else neg_edges).append(e)

    pos = {}
    for i, n in enumerate(users):
        pos[n] = (0, -i)
    for i, n in enumerate(items):
        pos[n] = (1, -i * len(users) / max(len(items), 1))

    fig, ax = plt.subplots(figsize=(8, max(4, len(items) // 4)))
    nx.draw_networkx_nodes(g, pos, nodelist=users, node_color="#4c72b0", ax=ax, node_size=120)
    nx.draw_networkx_nodes(g, pos, nodelist=items, node_color="#dd8452", ax=ax, node_size=120)
    nx.draw_networkx_edges(g, pos, edgelist=sub_edges, edge_color="#aaaaaa", ax=ax)
    nx.draw_networkx_edges(g, pos, edgelist=pos_edges, edge_color="green", width=2, ax=ax)
    nx.draw_networkx_edges(g, pos, edgelist=neg_edges, edge_color="red", width=2, ax=ax)
    nx.draw_networkx_labels(g, pos, font_size=6, ax=ax)
    ax.set_axis_off()
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return fig
