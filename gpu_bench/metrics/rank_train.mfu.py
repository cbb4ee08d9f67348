"""The ranking train step's share of the card's peaks: the compulsory work
of every step of the untraced window, from its batch's valid user and item
slots, edges and label pairs (``work.sage_forward``, its backward at twice
the forward, Adam over every parameter; f32), over that window's wall time,
in %."""
import sys

from gpu_bench import work


def step_seconds(s, c):
    f = c["features"]
    dec = ([2 * c["encoder_layer_output_size"]]
           + [c["hidden_layer_size"]] * (c["num_linear_layers"] - 1) + [1])
    fwd = work.sage_forward(s["user_slots"], s["item_slots"], s["edges"], s["labels"],
                            f["embedding_dim"] * f["user_columns"],
                            f["embedding_dim"] * f["item_columns"], c["hidden_layer_size"],
                            c["encoder_layer_output_size"], c["num_gnn_layers"],
                            list(zip(dec[:-1], dec[1:])))
    return work.total_seconds(work.sage_train_step(fwd, s["params"]))


def read(record):
    shapes = record["shapes"]
    if not shapes:
        return None
    n = len(shapes)
    print("rank_train.mfu: mean valid edges %.1f, user slots %.1f, item slots %.1f, labels %.1f a step"
          % tuple(sum(s[k] for s in shapes) / n for k in ("edges", "user_slots", "item_slots", "labels")),
          file=sys.stderr)
    return 100.0 * sum(step_seconds(s, record["config"]) for s in shapes) / record["window_s"]
