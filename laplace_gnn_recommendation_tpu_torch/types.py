"""Typed schemas for datasets, preprocessing, and feature metadata (a copy
of the JAX package's ``types.py``).

Counterpart of the reference's ``data/types.py:9-63``: the same
vocabulary of feature columns and preprocessing switches, plus the padded
static-shape artifact descriptors the JAX pipeline needs (the reference keeps
ragged Python dicts; on TPU every array has a static shape, so artifact
metadata carries pad sizes explicitly).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import Enum
from typing import List, Optional, Tuple


class UserColumn(Enum):
    """Customer feature columns (reference ``data/types.py:9-16``)."""

    PostalCode = "postal_code"
    FN = "FN"
    Age = "age"
    ClubMemberStatus = "club_member_status"
    FashionNewsFrequency = "fashion_news_frequency"
    Active = "Active"


class ArticleColumn(Enum):
    """Article feature columns (reference ``data/types.py:18-24``)."""

    ProductCode = "product_code"
    ProductTypeNo = "product_type_no"
    GraphicalAppearanceNo = "graphical_appearance_no"
    ColourGroupCode = "colour_group_code"
    AvgPrice = "avg_price"
    ImgEmbedding = "img_embedding"


@dataclass
class PreprocessingConfig:
    """Tabular→graph preprocessing switches (reference ``data/types.py:32-56``).

    ``data_type`` is dropped: there is a single TPU-native graph artifact
    format (see :mod:`..data.graph`) instead of the reference's PyG/DGL fork.
    """

    customer_features: List[UserColumn]
    article_features: List[ArticleColumn]
    article_non_categorical_features: List[ArticleColumn]
    filter_out_unconnected_nodes: bool
    load_image_embedding: bool
    load_text_embedding: bool
    text_embedding_colname: Optional[str]
    data_size: Optional[int]

    def print(self) -> None:
        print("Configuration is:")
        for key, value in vars(self).items():
            print(f"{key:>20}: {value}")


@dataclass
class FeatureInfo:
    """Per-node-type categorical feature metadata (reference ``data/types.py:59-63``).

    ``num_cat[i]`` is the max category id of feature column ``i`` (embedding
    tables are sized ``num_cat[i] + 1``); ``embedding_size[i]`` comes from the
    cardinality→dim policy table (``configs.embedding_range_dict``).
    """

    num_feat: int
    num_cat: List[int]
    embedding_size: List[int]


@dataclass(frozen=True)
class EdgeType:
    """A typed edge ``src_node_type --relation--> dst_node_type``.

    Replaces the reference's ``(str, str, str)`` tuples
    (``utils/constants.py:13-15``) with a hashable dataclass.
    """

    src: str
    rel: str
    dst: str

    def reverse(self, rel: Optional[str] = None) -> "EdgeType":
        return EdgeType(self.dst, rel or f"rev_{self.rel}", self.src)

    def as_tuple(self) -> Tuple[str, str, str]:
        return (self.src, self.rel, self.dst)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.src}--{self.rel}-->{self.dst}"
