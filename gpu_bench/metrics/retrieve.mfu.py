"""Retrieval's share of the card's peaks: the compulsory masked-MIPS work of
every request answered in the untraced window (``work.masked_mips`` from its
users, catalog, width, k and excluded pairs: user rows and the catalog read
once a request, the exclusion ids, k results out; f32 products, TF32 off)
over that window's wall time, in %."""
from gpu_bench import work


def read(record):
    shapes = record["shapes"]
    if not shapes:
        return None
    need = sum(work.seconds(work.masked_mips(s["users"], s["items"], s["width"], s["k"],
                                             s["excluded"])) for s in shapes)
    return 100.0 * need / record["window_s"]
