"""Graph-schema constants: node and edge type names (a copy of the JAX
package's ``constants.py``).

Mirrors the reference's ``utils/constants.py:4-21`` — the hetero graph is
``customer --buys--> article`` with reverse ``article --rev_buys--> customer``
and an optional extra node type keyed by colour group.
"""
from .types import ArticleColumn, EdgeType

NODE_USER = "customer"
NODE_ITEM = "article"
REL_TYPE = "buys"
REL_REV_TYPE = "rev_buys"
NODE_EXTRA = ArticleColumn.ColourGroupCode.value
REL_TYPE_EXTRA = "has_color"

EDGE_KEY = EdgeType(NODE_USER, REL_TYPE, NODE_ITEM)
REV_EDGE_KEY = EdgeType(NODE_ITEM, REL_REV_TYPE, NODE_USER)
EDGE_KEY_EXTRA = EdgeType(NODE_ITEM, REL_TYPE_EXTRA, NODE_EXTRA)


class Constants:
    """Namespace alias kept for parity with reference ``utils/constants.py:12-21``."""

    edge_key = EDGE_KEY
    rev_edge_key = REV_EDGE_KEY
    edge_key_extra = EDGE_KEY_EXTRA
    node_user = NODE_USER
    node_item = NODE_ITEM
    rel_type = REL_TYPE
    rel_rev_type = REL_REV_TYPE
    rel_type_extra = REL_TYPE_EXTRA
    node_extra = NODE_EXTRA
