"""Command-line entry point — the port of the JAX package's ``cli.py``
(reference ``run_command.py:8-47``): one ``--flag`` per config dataclass
field plus a ``--type`` dispatch:

    python -m laplace_gnn_recommendation_tpu_torch.cli --type preprocess
    python -m laplace_gnn_recommendation_tpu_torch.cli --type preprocess_fashion
    python -m laplace_gnn_recommendation_tpu_torch.cli --type lightgcn
    python -m laplace_gnn_recommendation_tpu_torch.cli --type encoder
    python -m laplace_gnn_recommendation_tpu_torch.cli --type submission
    python -m laplace_gnn_recommendation_tpu_torch.cli --type hpo
    python -m laplace_gnn_recommendation_tpu_torch.cli --type pinsage

``preprocess_fashion`` reads the H&M parquet files through pandas (and a
parquet engine such as pyarrow); the other types need torch and numpy only.

On a multi-GPU host the training types run one process per card under
``torchrun``, on the mesh the axis flags give:

    torchrun --nproc_per_node=4 -m laplace_gnn_recommendation_tpu_torch.cli \\
        --type lightgcn --mesh_data_axis 2 --mesh_model_axis 2

Each rank runs on ``cuda:{LOCAL_RANK}`` unless ``--device`` says otherwise
(``--device cpu`` runs the ranks on the CPU over gloo); ``--dist_init_method``
replaces torchrun's ``env://`` rendezvous (a ``file://`` path takes no
port). The training types print ``FINAL_STATS <json>`` on every rank.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from .configs import (
    add_dataclass_args,
    apply_parsed_args,
    lightgcn_config,
    link_pred_config,
    preprocessing_config,
)

def run() -> None:
    parser = argparse.ArgumentParser(description="laplace_gnn_recommendation_tpu_torch")
    parser.add_argument(
        "--type",
        required=True,
        choices=["preprocess", "preprocess_fashion", "lightgcn", "encoder",
                 "submission", "hpo", "pinsage"],
    )
    parser.add_argument("--artifact_dir", default="data/derived")
    parser.add_argument("--raw_dir", default="data/original")
    parser.add_argument("--mesh_data_axis", type=int, default=None)
    parser.add_argument("--mesh_model_axis", type=int, default=None)
    parser.add_argument("--model_dir", default="model/saved")
    parser.add_argument("--device", default=None,
                        help="this rank's device (default cuda:$LOCAL_RANK)")
    parser.add_argument("--dist_init_method", default=None,
                        help="rendezvous of a multi-rank launch (default env://)")
    parser.add_argument(
        "--resume",
        type=lambda s: s.lower() in ("1", "true", "yes"),
        nargs="?", const=True, default=False,
    )
    add_dataclass_args(parser, link_pred_config)
    add_dataclass_args(parser, lightgcn_config)
    args, _ = parser.parse_known_args()

    if args.type == "preprocess":
        from .data.preprocess_movielens import preprocess

        preprocess(preprocessing_config, args.raw_dir, args.artifact_dir)
        return
    if args.type == "preprocess_fashion":
        from .data.preprocess_fashion import preprocess

        preprocess(preprocessing_config, args.raw_dir, args.artifact_dir)
        return

    from .parallel.mesh import distributed_init, rank_device

    dev = rank_device(args.device)
    distributed_init(init_method=args.dist_init_method, device=dev)

    def with_mesh(cfg):
        if args.mesh_data_axis is not None:
            cfg.mesh.data_axis = args.mesh_data_axis
        if args.mesh_model_axis is not None:
            cfg.mesh.model_axis = args.mesh_model_axis
        return cfg

    from .data.link_pred_data import create_link_pred_data_from_artifacts

    if args.type == "lightgcn":
        from .data.lightgcn_data import lightgcn_data_from_hetero
        from .train.lightgcn_pipeline import train

        cfg = with_mesh(apply_parsed_args(lightgcn_config, args))
        bundle, _ = create_link_pred_data_from_artifacts(args.artifact_dir, link_pred_config,
                                                         device=dev)
        data = lightgcn_data_from_hetero(bundle.graph, device=dev)
        stats = train(cfg, data, device=dev)
        print("FINAL_STATS " + json.dumps(dataclasses.asdict(stats)), flush=True)
    elif args.type == "encoder":
        from .train.encdec_pipeline import run_pipeline

        cfg = with_mesh(apply_parsed_args(link_pred_config, args))
        data, _ = create_link_pred_data_from_artifacts(args.artifact_dir, cfg, device=dev)
        stats = run_pipeline(cfg, data, model_dir=args.model_dir, resume=args.resume,
                             device=dev)
        print("FINAL_STATS " + json.dumps(dataclasses.asdict(stats)), flush=True)
    elif args.type == "submission":
        from .train.submission import submission_pipeline

        cfg = apply_parsed_args(link_pred_config, args)
        data, artifacts = create_link_pred_data_from_artifacts(args.artifact_dir, cfg, device=dev)
        submission_pipeline(
            cfg, data,
            {str(k): v for k, v in artifacts.customer_id_map_forward.items()},
            {str(k): v for k, v in artifacts.article_id_map_forward.items()},
            model_dir=args.model_dir,
        )
    elif args.type == "hpo":
        from .train.hpo import run_hpo

        run_hpo(args.artifact_dir, device=dev)
    elif args.type == "pinsage":
        from .train.pinsage_pipeline import run_pinsage_cli

        run_pinsage_cli(args.artifact_dir, device=dev)


if __name__ == "__main__":
    import torch.distributed as dist

    try:
        run()
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
