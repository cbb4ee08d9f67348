"""Experiment configuration system (a copy of the JAX package's
``configs.py``; the port keeps every field and default so one config drives
both packages — ``MeshConfig`` rides along as an inert field until the
multi-GPU slice).

Counterpart of the reference's ``config.py:22-177`` +
``run_command.py:8-47``: dataclass configs with validation, printed dumps,
the cardinality→embedding-dim policy table, and a generic CLI that exposes
one ``--flag`` per dataclass field. New TPU-only knobs (mesh shape, dtype,
pad multiples) live on :class:`MeshConfig`, which the reference — being
single-device — has no analogue of.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

from .constants import EDGE_KEY, NODE_ITEM, NODE_USER
from .types import ArticleColumn, EdgeType, PreprocessingConfig, UserColumn

# Cardinality → embedding dim policy (reference ``config.py:12-19``).
embedding_range_dict = {
    "2": 2,
    "10": 4,
    "1000": 12,
    "10000": 20,
    "100000": 40,
    "1000000": 60,
}


def embedding_size_for_cardinality(num_cat: int) -> int:
    """Pick the embedding dim for a categorical column.

    Reference ``utils/get_info.py:10-31`` walks ``embedding_range_dict`` keys
    in order and takes the first bucket whose upper bound exceeds the
    cardinality (falling back to the largest bucket).
    """
    for upper, dim in embedding_range_dict.items():
        if num_cat <= int(upper):
            return dim
    return list(embedding_range_dict.values())[-1]


@dataclass
class MeshConfig:
    """TPU device-mesh layout. No reference analogue (single-device there).

    The mesh is 2-D: ``data`` (batch parallelism) × ``model`` (row-sharded
    embedding tables, sharded SpMM / MIPS). ``data_axis * model_axis`` must
    equal the number of participating devices; ``-1`` lets either axis absorb
    whatever is available.
    """

    data_axis: int = -1
    model_axis: int = 1
    dtype: str = "float32"  # accumulation dtype; matmuls run bf16 on MXU
    compute_dtype: str = "float32"


@dataclass
class Config:
    """Hetero encoder-decoder (link prediction) config.

    Field-for-field equivalent of reference ``config.py:22-74``; fields that
    only made sense for torch DataLoaders (``num_workers``) are kept for CLI
    compatibility but drive the host-side prefetcher instead. New fields are
    grouped at the bottom.
    """

    wandb_enabled: bool = False
    epochs: int = 4
    hidden_layer_size: int = 128
    encoder_layer_output_size: int = 64
    k: int = 12
    num_gnn_layers: int = 2
    num_linear_layers: int = 2
    learning_rate: float = 0.01
    conv_agg_type: str = "add"  # "add" | "mean" | "max"
    heterogeneous_prop_agg_type: str = "sum"  # "sum" | "mean" | "min" | "max" | "mul"
    save_model: bool = False
    eval_every: int = 1
    save_every: float = 0.2

    batch_size: int = 24
    num_neighbors: int = 64
    n_hop_neighbors: int = 3
    num_workers: int = 1
    candidate_pool_size: int = 20
    positive_edges_ratio: float = 0.5
    negative_edges_ratio: float = 3.0
    batch_norm: bool = True
    matchers: str = "movielens"  # "fashion" | "movielens"

    p_dropout_edges: Optional[float] = 0.2  # dead in reference too (config.py:123)
    p_dropout_features: Optional[float] = 0.3

    default_edge_types: List[EdgeType] = field(default_factory=lambda: [EDGE_KEY])
    other_edge_types: List[EdgeType] = field(default_factory=list)
    node_types: List[str] = field(default_factory=lambda: [NODE_USER, NODE_ITEM])

    evaluate_break_at: Optional[int] = None
    seed: int = 5  # reference seeds via seed_everything(5) (run_pipeline.py:30)

    # --- TPU-native additions (no reference analogue) ---
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # static pad sizes for the subgraph batch; see data/sampler.py
    max_edges_per_batch: Optional[int] = None  # None → derived from fanout
    max_labels_per_user: Optional[int] = None
    artifact_dir: str = "data/derived"
    # budget for densifying the per-batch subgraph adjacency so the SAGE
    # convs ride the MXU instead of edge gathers + segment sums
    # (models/sage.py encode); 0 disables. f32 A + Aᵀ must fit.
    dense_bytes_budget: int = 256 << 20
    # probed pad budgets: N>0 samples N batches per split at build time and
    # tightens the node/edge pad budgets to observed-max × 1.5 (bounded by
    # the static worst-case derivation). The static formula over-provisions
    # ~10-20× on power-law graphs (it models per-seed worst cases with no
    # cross-seed sharing), and every conv segment-sum pays for the padding;
    # the runtime truncation telemetry remains the correctness guard.
    # 0 = static budgets (bit-stable shapes across runs).
    budget_probe: int = 0

    def print(self) -> None:
        print("\nConfiguration is:")
        for key, value in vars(self).items():
            print(f"{key:>28}: {value}")

    def check_validity(self) -> None:
        # Mirrors reference config.py:67-74.
        assert self.positive_edges_ratio <= 1.0, (
            "Positive Edges ratio has to be smaller than 1.0"
        )
        if self.p_dropout_edges is not None:
            assert self.p_dropout_edges <= 1.0
        if self.p_dropout_features is not None:
            assert self.p_dropout_features <= 1.0
        # run_pipeline.py:32-34
        assert self.k <= self.candidate_pool_size * 2, (
            "k must be smaller than candidate_pool_size"
        )


@dataclass
class LightGCNConfig:
    """LightGCN config — reference ``config.py:77-96`` plus TPU knobs."""

    epochs: int = 10000
    hidden_layer_size: int = 32
    k: int = 12
    learning_rate: float = 1e-3
    save_model: bool = False
    eval_every: int = 100
    lr_decay_every: int = 100
    Lambda: float = 1e-6
    batch_size: int = 128
    num_iterations: int = 4
    show_graph: bool = False
    num_recommendations: int = 256
    seed: int = 42

    # --- TPU-native additions ---
    mesh: MeshConfig = field(default_factory=MeshConfig)
    bpr_variant: str = "canonical"
    """``canonical`` → -mean(logsigmoid(pos-neg)) + λ‖E⁰‖² (the LightGCN /
    BPR-paper loss). ``legacy`` reproduces the reference's sign quirk
    -mean(softplus(pos-neg)) + reg (``utils/metrics_lightgcn.py:43``), whose
    loss goes negative by design (see the commented acceptance floor
    ``tests/test_acceptance_lightgcn.py:53`` `loss < -0.8`)."""
    artifact_dir: str = "data/derived"
    dense_bytes_budget: int = 4 << 30
    """When Ã + Ãᵀ fit in this many bytes as dense bf16, propagation runs as
    MXU matmuls (≈28× faster at ML-1M scale); 0 forces the segment-sum SpMM
    path (required for graphs at H&M scale)."""
    propagation: str = "auto"
    """Propagation operand: ``auto`` (sharded when the mesh's model axis > 1,
    else dense when it fits ``dense_bytes_budget``, else blocked) |
    ``dense`` | ``blocked`` | ``plain`` (segment-sum) | ``sharded``."""
    eval_user_cap: Optional[int] = None
    """Evaluate ranking metrics on at most this many users per split (the
    first N of the split's sorted unique users). ``None`` = all users — the
    reference behavior. At H&M scale (1.37M users) a full metric sweep per
    eval is minutes; production runs cap it and keep the full sweep for the
    final test pass."""
    select_best_val: bool = False
    """Model selection: report test metrics (and export artifacts) from the
    parameters with the best val recall seen at any eval point, instead of
    the last iterate (the reference's behavior, kept as the default). The
    last iterate gets a final val eval before selection so a late
    improvement is never discarded."""
    return_params: bool = False
    """Attach the final (post-selection) parameters to the returned
    ``Stats.params`` so callers can score/serve the trained model without
    re-loading exported artifacts (off by default: keeps device arrays from
    outliving ``train()`` in ordinary runs)."""
    checkpoint_every: int = 0
    """Write a (params, opt_state) checkpoint every N iterations into
    ``artifact_dir/lightgcn_ckpt`` (orbax when the mesh's model axis is >1,
    flat npz otherwise — see ``train/checkpoint.py``). 0 disables. The
    reference's 10k-iteration default runs for hours with no mid-run
    persistence (``run_pipeline_lightgcn.py`` saves only final tables)."""
    resume: bool = False
    """Resume from the newest checkpoint in ``artifact_dir/lightgcn_ckpt``:
    restores params + optimizer (schedule step included) and continues from
    the checkpoint's iteration; the sampling key stream is re-seeded by
    fold-in, so resumed draws are decorrelated, not replayed."""

    def print(self) -> None:
        print("\nConfiguration is:")
        for key, value in vars(self).items():
            print(f"{key:>28}: {value}")


# --- shipped default instances (reference config.py:99-177) ---

link_pred_config = Config()

lightgcn_config = LightGCNConfig()

preprocessing_config = PreprocessingConfig(
    customer_features=[
        UserColumn.PostalCode,
        UserColumn.FN,
        UserColumn.Age,
        UserColumn.ClubMemberStatus,
        UserColumn.FashionNewsFrequency,
        UserColumn.Active,
    ],
    article_features=[
        ArticleColumn.ProductCode,
        ArticleColumn.ProductTypeNo,
        ArticleColumn.GraphicalAppearanceNo,
        ArticleColumn.ColourGroupCode,
    ],
    article_non_categorical_features=[ArticleColumn.ImgEmbedding],
    filter_out_unconnected_nodes=True,
    load_image_embedding=False,
    load_text_embedding=False,
    text_embedding_colname="derived_look",
    data_size=10_000,
)


# --- generic CLI (reference run_command.py:8-47) ---

_CLI_SKIP_TYPES = (list, dict, MeshConfig)


def _optional_field_type(f: dataclasses.Field):
    """Element type of an ``Optional[...]`` annotation (string-form safe)."""
    t = str(f.type)
    if "int" in t:
        return int
    if "float" in t:
        return float
    return str


def add_dataclass_args(parser: argparse.ArgumentParser, instance) -> None:
    """Auto-create one ``--flag`` per simple dataclass field.

    Flags use ``argparse.SUPPRESS`` defaults so the namespace only contains
    values the user actually passed — ``apply_parsed_args`` must be able to
    tell user input from another config's defaults (two configs share field
    names like ``epochs``; first registration wins on the flag itself, but
    each config keeps its own dataclass default).
    """
    existing = {
        s for a in parser._actions for s in a.option_strings  # noqa: SLF001
    }
    for f in dataclasses.fields(instance):
        value = getattr(instance, f.name)
        if isinstance(value, _CLI_SKIP_TYPES) or f.name in ("mesh",):
            continue
        if f"--{f.name}" in existing:
            continue
        if isinstance(value, bool):
            parser.add_argument(
                f"--{f.name}",
                type=lambda s: s.lower() in ("1", "true", "yes"),
                default=argparse.SUPPRESS,
            )
        elif value is None:
            parser.add_argument(
                f"--{f.name}",
                type=_optional_field_type(f),
                default=argparse.SUPPRESS,
            )
        else:
            parser.add_argument(
                f"--{f.name}", type=type(value), default=argparse.SUPPRESS
            )


def apply_parsed_args(instance, args: argparse.Namespace):
    """Write user-passed CLI values back onto the dataclass instance in
    place (flags the user did not pass are absent from the namespace)."""
    for f in dataclasses.fields(instance):
        if hasattr(args, f.name):
            setattr(instance, f.name, getattr(args, f.name))
    return instance
